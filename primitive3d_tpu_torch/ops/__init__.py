"""Surface extraction: marching cubes, marching tetrahedra, tables."""
