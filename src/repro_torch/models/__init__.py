"""Models: the dense decoder transformer."""
