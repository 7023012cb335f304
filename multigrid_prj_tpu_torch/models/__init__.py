"""Problem definitions: the 2D/3D Poisson model problems."""
