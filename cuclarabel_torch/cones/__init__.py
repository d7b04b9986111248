"""Cone specifications, the static layout and the batched cone ops."""
