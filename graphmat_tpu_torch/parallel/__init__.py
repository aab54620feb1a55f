"""The 2D-sharded engine: meshes, the sharded graph, its iteration loop
and whole-graph operations, and multi-process start-up."""
