"""Hand-written Hopper tile kernels of the port, their plain PyTorch twins
(:mod:`.ref`) and the dispatch over them (:mod:`.ops`)."""
