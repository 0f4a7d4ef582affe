"""Launch entry points (twin of repro.launch): `serve` drives protected
serving end to end. Training's mesh and steps wait for ROADMAP item
1.12."""
