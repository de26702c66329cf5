"""Device engines of the port: the CUDA kernel, its plain version, canvas."""
