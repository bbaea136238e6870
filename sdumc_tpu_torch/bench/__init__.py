"""Measurements on the card that the kernels' designs rest on."""
