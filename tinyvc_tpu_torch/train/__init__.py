"""Decoder GAN training: the pre-join and post-join steps and their loop."""
