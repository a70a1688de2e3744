"""Launch-layer vocabulary of the port.

Holds only :mod:`.mesh_shapes`, a copy of the reference's jax-free mesh
shape and axis-role helpers, which the simulator's device topology
(:mod:`repro_torch.sim.topology`) speaks.  Building real device meshes over
``torch.distributed`` is later work.
"""
