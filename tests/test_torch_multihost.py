"""Multi-process bring-up of the port (``approximatenn_tpu_torch/parallel/
multihost.py`` and ``dryrun.py``) on the CPU, the counterpart of
``tests/test_multihost.py``: two gloo processes joined through a real
host:port rendezvous, each fed only its own rows (``host_shard_slice`` +
``process_local_array``), run the sharded build, hash search and exact
search; ``initialize``'s refusal to degrade in a cluster context; the dry
run.  No JAX: the exact search is held to a float64 brute force (the same
id set per row outside near-ties, distances within 1024 float32 ULPs,
``torch_sharded_ranks.assert_parity``), as the JAX test holds its own.
"""

import socket
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from approximatenn_tpu_torch.parallel import dryrun, multihost
from approximatenn_tpu_torch.parallel import sharded as sh
from torch_sharded_ranks import K, assert_parity, brute, ok, run_suite

torch.set_num_threads(1)

HINT_VARS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "MEGASCALE_COORDINATOR_ADDRESS",
             "TPU_WORKER_HOSTNAMES", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "WORLD_SIZE",
             "MASTER_ADDR", "MASTER_PORT", "RANK")


def fake_mesh(rank: int, size: int) -> sh.Mesh:
    return sh.Mesh(group=None, rank=rank, size=size, device=torch.device("cpu"))


@pytest.fixture()
def no_cluster_env(monkeypatch):
    for v in HINT_VARS:
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


def test_two_process_distributed_build_search(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rng = np.random.default_rng(0)  # the same global view on each rank
    X = rng.standard_normal((256, 16)).astype(np.float32)
    Y = rng.standard_normal((8, 16)).astype(np.float32)
    outs = run_suite("multihost", dict(X=X, Y=Y), tmp_path, extra=["--port", str(port)])
    want_ids, want_d = brute(X, Y, K)
    for r, out in enumerate(outs):
        ok(out, "multihost")
        assert tuple(out["multihost.slice"]) == ((0, 128) if r == 0 else (128, 256))
        assert int(out["multihost.n_local"]) == 128
        assert_parity(out["multihost.eids"], out["multihost.edd"], want_ids, want_d)
        hids = out["multihost.ids"]
        assert hids.shape == (8, K) and hids.min() >= 0 and hids.max() <= 256
        assert float(np.mean(hids[:, 0] == want_ids[:, 0])) >= 0.5  # hash top-1 floor
    np.testing.assert_array_equal(outs[0]["multihost.ids"], outs[1]["multihost.ids"])


@pytest.mark.parametrize("rank", [0, 1])
def test_host_shard_slice(rank):
    assert multihost.host_shard_slice(256, fake_mesh(rank, 2)) == (128 * rank, 128 * (rank + 1))
    with pytest.raises(ValueError, match="divisible"):
        multihost.host_shard_slice(255, fake_mesh(rank, 2))


def test_process_local_array_must_be_pre_padded():
    """A rank's rows of an n that does not divide the shard count: the
    sharded entry points refuse them (they cannot pad another rank's
    rows), as the JAX package refuses a non-addressable corpus."""
    mesh = fake_mesh(0, 2)
    rows = multihost.process_local_array((129, 16), mesh, np.zeros((65, 16), np.float32))
    assert rows.shape == (129, 16) and rows.dtype == torch.float32
    with pytest.raises(ValueError, match="pre-padded"):
        sh.build_sharded(rows, K, mesh=mesh)
    with pytest.raises(ValueError, match="pre-padded"):
        sh.search_exact_sharded(rows, np.zeros((2, 16), np.float32), K, mesh=mesh)
    with pytest.raises(ValueError, match="rows"):
        multihost.process_local_array((128, 16), mesh, np.zeros((60, 16), np.float32))


def test_initialize_fails_loudly_with_cluster_env(no_cluster_env):
    """Partial explicit arguments and cluster variables that name more than
    one participant raise instead of degrading to one process."""
    mp = no_cluster_env
    with pytest.raises(RuntimeError, match="refusing to degrade"):
        multihost.initialize(num_processes=2, backend="gloo")
    for var, value in (("SLURM_NTASKS", "2"), ("TPU_WORKER_HOSTNAMES", "host-a,host-b"),
                       ("WORLD_SIZE", "2"), ("COORDINATOR_ADDRESS", "10.0.0.1:1234")):
        mp.setenv(var, value)
        assert var in multihost._cluster_env_hints()
        with pytest.raises(RuntimeError, match="refusing to degrade"):
            multihost.initialize(backend="gloo")
        mp.delenv(var)
    assert not dist.is_initialized()


def test_initialize_stays_local_without_cluster_evidence(no_cluster_env):
    """Single-participant values of the same variables are no cluster: a
    one-rank group on an in-process store, and a second call is a no-op."""
    mp = no_cluster_env
    mp.setenv("TPU_WORKER_HOSTNAMES", "localhost")
    mp.setenv("SLURM_NTASKS", "1")
    mp.setenv("WORLD_SIZE", "1")
    assert multihost._cluster_env_hints() == []
    try:
        multihost.initialize(backend="gloo", timeout=30)
        assert dist.get_world_size() == 1
        multihost.initialize(num_processes=2, backend="gloo")  # no-op
        mesh = multihost.global_mesh(device="cpu")
        assert (mesh.rank, mesh.size, mesh.host_staged) == (0, 1, False)
        with pytest.raises(ValueError, match="n_devices"):
            sh.make_mesh(n_devices=2, device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_initialize_without_a_card_needs_the_cpu_asked_for(no_cluster_env):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default backend is NCCL there")
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        multihost.initialize()
    assert not dist.is_initialized()


def test_dryrun_multichip():
    """Every step of the dry run, the ShardedServer ones included, ran on
    both ranks (each rank's last line names the steps it passed)."""
    outs = dryrun.dryrun_multichip(2, device="cpu", timeout=240)
    for r, out in enumerate(outs):
        last = out.strip().splitlines()[-1]
        assert last.startswith(f"rank {r}: ok")
        for step in dryrun.DRYRUN_STEPS:
            assert step in last
        assert "ShardedServer exact two-phase" in last and "ShardedServer hash packed" in last


def test_dryrun_multichip_defaults_to_the_card(monkeypatch):
    # no card and no device="cpu": it raises before it starts a rank
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dryrun, "launch", lambda *a, **kw: pytest.fail("ranks started"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dryrun.dryrun_multichip(2)


def test_launch_names_the_failing_rank_and_stops_the_others():
    code = ("import sys, time\n"
            "rank = int(sys.argv[sys.argv.index('--rank') + 1])\n"
            "if rank == 1: sys.exit(3)\n"
            "time.sleep(60)\n")
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed .exit code 3"):
        dryrun.launch([sys.executable, "-c", code], 2, timeout=60)


def test_launch_times_out():
    code = "import time; time.sleep(60)"
    with pytest.raises(RuntimeError, match="did not finish in 2"):
        dryrun.launch([sys.executable, "-c", code], 2, timeout=2)
