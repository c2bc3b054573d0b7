"""Inference layer of the port: tokenizer, engine, worker."""
