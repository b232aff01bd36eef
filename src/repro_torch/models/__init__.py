"""The dense LM family: config, layers, GQA attention and the decoder."""
