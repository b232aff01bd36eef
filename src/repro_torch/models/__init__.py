"""The decoder-only LM families: config, layers, GQA and MLA attention, the
MoE FFN and the decoder."""
