"""Morton codes and the cluster structure of the ray caster."""
