"""Serving: the batched multi-job stitch queue and its HTTP front end."""
