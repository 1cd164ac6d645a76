"""Core integer color math shared by the codecs, on torch integer tensors."""
