"""Alignment paths: the host walker and Hirschberg, and the batched capture
route on the card."""
