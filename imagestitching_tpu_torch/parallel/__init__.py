"""Batched execution of the port: many jobs of one plan in one launch per
placement."""
