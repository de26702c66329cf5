"""Entry points that measure the port on the card (``python -m``)."""
