"""Synthetic datasets and node partitioners of the port."""
