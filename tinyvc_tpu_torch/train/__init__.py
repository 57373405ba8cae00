"""Decoder GAN training: the pre-join step and its loop."""
