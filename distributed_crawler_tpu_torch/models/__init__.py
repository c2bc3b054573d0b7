"""Models of the port: the E5/XLM-R encoder and the flax param loader."""
