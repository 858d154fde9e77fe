"""Checkpoints of the port: the atomic-directory protocol and trees of
tensors saved, restored and written in the background."""
