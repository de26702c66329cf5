"""The plain reference: a frozen layout and a plain PyTorch stitch."""
