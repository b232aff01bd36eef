"""Step factories and the serving driver of the LM path."""
