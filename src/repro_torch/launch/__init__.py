"""Launch layer of the port.

* :mod:`.mesh_shapes` — a copy of the reference's jax-free mesh shape and
  axis-role helpers, which the simulator's device topology
  (:mod:`repro_torch.sim.topology`) also speaks;
* :mod:`.mesh` — ``torch.distributed`` functions that build ``DeviceMesh``es over them;
* :mod:`.shardings` — :func:`~.shardings.make_plan`, the sharding policy
  of a (config × shape × mesh) as PartitionSpecs and DTensor placements.
"""
