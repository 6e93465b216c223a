"""Surface extraction: marching cubes and its tables."""
