"""The distribution layer (port of ``approximatenn_tpu/parallel/``) on
``torch.distributed``: one process a shard, NCCL on the card and gloo on
the CPU.

- :mod:`.multihost`: bring-up (``initialize``), the global mesh and each
  rank's rows (``host_shard_slice``, ``process_local_array``);
- :mod:`.sharded`: the row-sharded index (``build_sharded``), its
  searches over the padded tables, the packed view and the exact engine,
  each merged with one all-gather top-k;
- :mod:`.serving`: ``ShardedServer`` (the per-shard engine, storage tier
  and two-phase routing over the mesh) and ``tune_sharded``;
- :mod:`.checkpoint`: the index's and the packed view's checkpoints in the
  JAX package's npz layout;
- :mod:`.dryrun`: ``dryrun_multichip``, the layer end to end in a few
  gloo processes on one machine.
"""
