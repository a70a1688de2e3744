"""Launch layer of the port.

* :mod:`.mesh_shapes` — a copy of the reference's jax-free mesh shape and
  axis-role helpers, which the simulator's device topology
  (:mod:`repro_torch.sim.topology`) also speaks;
* :mod:`.mesh` — ``torch.distributed`` functions that build ``DeviceMesh``es over them;
* :mod:`.shardings` — :func:`~.shardings.make_plan`, the sharding policy
  of a (config × shape × mesh) as PartitionSpecs and DTensor placements;
* :mod:`.dtensors` — the DTensor helpers a step placed on a mesh runs
  through: collectives over mesh dims, placements of one tensor from
  another's, and the embedding lookup and decode-cache write on shards;
* :mod:`.steps` — :func:`~.steps.build_cell`, a cell's step, its abstract
  inputs and their placements (and :func:`~.steps.materialize`, real ones);
* :mod:`.dryrun` — every cell built and counted on the CPU
  (``python -m repro_torch.launch.dryrun``).
"""
