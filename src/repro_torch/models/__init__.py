"""The LM substrate: layers, attention and the decoder (dense family)."""
