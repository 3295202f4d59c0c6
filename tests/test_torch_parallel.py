"""strique_tpu_torch's multi-device and multi-host ``count`` on the CPU.

The counterpart of the JAX package's mesh tests (tests/test_sharding.py,
tests/test_cli_mesh.py, tests/test_multihost.py) for the port, whose
device lists may repeat a device: ``[cpu] * n`` drives every shard
and round-robin path of the multi-device logic on the CPU.

* ``RepeatCounter(device=[cpu] * n)`` against one device, on an odd
  batch (its rows pad to a multiple of 8 and of n, the pad rows never
  reach a result), and on a batch past the pointer budget (split by
  rows as any other, each shard running its own two-pass groups);
  ``align_longread_sharded(devices=...)`` against one device, and its
  groups' share of the rows on the card rule.  Tuples and outputs
  equal: every row is computed by the same plain twins.
* ``count --device cpu --devices 2`` byte for byte against
  ``--devices 1`` and the JAX package's ``count``.
* Two ``count`` processes over gloo (``--coordinator``, ``--num_hosts
  2``, ``--host_id``): one merged file, each read once, the
  single-process rows; the SAM stride splits the reads; a rank that
  finishes long after the rendezvous timeout still merges; ``--resume``
  across the shards; a failed rendezvous fails the run.
* ``init_distributed``'s idempotence and ``local_devices``.

Every subprocess and every rendezvous has its own timeout.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from strique_tpu.cli import main as jax_main
from strique_tpu_torch import cli
from strique_tpu_torch.detect import counter as counter_mod
from strique_tpu_torch.detect.counter import RepeatCounter
from strique_tpu_torch.ops import align as TA
from strique_tpu_torch.ops.reference import AlignParams
from strique_tpu_torch.parallel import mesh
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.synthetic import (LOCI, PREFIX, REPEAT, SUFFIX, make_reads,
                                        write_count_run, write_pore_model)

# one torch thread: the tier-1 run puts six workers on the machine's cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
T_PREFIX = PREFIX[-60:]
T_SUFFIX = SUFFIX[:60]
# a batch of 5 reads: 8 rows on 1 or 2 devices, 24 on 3
COUNTS = [5, 9, 12, 7, 6]
# the loci with 80-base flanks, as tests/test_torch_cli.py; four reads,
# two a process under --num_hosts 2
T_LOCI = {name: (c, b, e, r, p[-80:], s[:80]) for name, (c, b, e, r, p, s) in LOCI.items()}
RUN = [("c9orf72", 5, "+", 20), ("c9orf72", 9, "+", 20), ("c9orf72", 7, "+", 20),
       ("c9orf72", 11, "+", 20)]
PROC_TIMEOUT_S = 240  # a count process of this run takes ~15 s


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    return write_pore_model(str(tmp_path_factory.mktemp("model") / "synthetic_6mer.model"),
                            seed=11)


@pytest.fixture(scope="module")
def reads(model_file):
    pm = PoreModel(model_file)
    rng = np.random.default_rng(71)
    return [make_reads(pm, 1, n, rng, flank_bases=100, prefix=T_PREFIX,
                       suffix=T_SUFFIX)[0] for n in COUNTS]


def _counter(model_file, devices):
    c = RepeatCounter(model_file, device=devices)
    c.add_target("c9orf72", REPEAT, T_PREFIX, T_SUFFIX)
    return c


@pytest.fixture(scope="module")
def one_device(model_file, reads):
    return _counter(model_file, [CPU]).detect_many("c9orf72", reads, "+")


@pytest.mark.parametrize("n_dev", [2, 3])
def test_counter_devices_match_one_device(model_file, reads, one_device, n_dev, monkeypatch):
    """A batch's rows split into n contiguous shards, one align and one
    Viterbi call a shard, and give the single device's tuples."""
    assert [r[0] for r in one_device] == COUNTS
    rows = {"align": [], "viterbi": []}
    align, vit = counter_mod.align_fused_pair, counter_mod.viterbi_batch
    monkeypatch.setattr(counter_mod, "align_fused_pair",
                        lambda s, *a, **k: rows["align"].append(s.shape[0]) or align(s, *a, **k))
    monkeypatch.setattr(counter_mod, "viterbi_batch",
                        lambda o, *a: rows["viterbi"].append(o.shape[0]) or vit(o, *a))
    c = _counter(model_file, [CPU] * n_dev)
    assert c.devices == [CPU] * n_dev and c.device == CPU
    got = c.detect_many("c9orf72", reads, "+")
    assert got == one_device
    per = {2: 4, 3: 8}[n_dev]
    assert rows == {"align": [per] * n_dev, "viterbi": [per] * n_dev}


def test_counter_two_pass_batch_round_robins(model_file, reads, one_device, monkeypatch):
    """Past the pointer budget the batch splits by rows as any other: each
    shard runs its own two-pass groups on its device entry; the tuples
    are the single device's (one-pass) ones."""
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "0.0001")
    seen = []
    two_pass_rows = TA._two_pass_rows
    monkeypatch.setattr(TA, "_two_pass_rows", lambda s, *a, **k: seen.append(
        (s.shape[0], k.get("devices"))) or two_pass_rows(s, *a, **k))
    got = _counter(model_file, [CPU] * 2).detect_many("c9orf72", reads, "+")
    assert got == one_device
    assert seen == [(4, None)] * 4  # a shard of 4 rows a device, one call a flank (CPU rule)


@pytest.mark.parametrize("n_dev,rows,groups", [(1, 16, [16]), (2, 16, [8, 8]),
                                               (2, 20, [16, 8]), (3, 20, [8, 8, 8])])
def test_two_pass_groups_cover_every_device(n_dev, rows, groups, monkeypatch):
    """On the card rule (as wide as the SM count allows) a two-pass
    group takes at most its device's share of the rows, so that every
    device entry runs one; the outputs stay the single device's."""
    rng = np.random.default_rng(911)
    N, M = 2048, 40
    template = rng.uniform(60, 120, M).astype(np.float32)
    sig = torch.from_numpy(rng.uniform(60, 120, (rows, N)).astype(np.float32))
    n = torch.from_numpy(rng.integers(N - 3 * M, N, rows).astype(np.int32))
    ref = TA.align_longread_sharded(sig, n, template, AlignParams(), ckpt_steps=512)
    monkeypatch.setattr(TA, "sm_count", lambda _dev: 132)  # an H100's SMs
    seen = []
    pass1 = TA._pass1_rows
    monkeypatch.setattr(TA, "_pass1_rows",
                        lambda s, *a, **k: seen.append(s.shape[0]) or pass1(s, *a, **k))
    got = TA.align_longread_sharded(sig, n, template, AlignParams(), devices=[CPU] * n_dev,
                                    ckpt_steps=512)
    assert seen == groups
    for k in ("score", "j_end", "is_gap", "jpos", "j_begin"):
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("n_dev", [1, 2, 3])
def test_longread_sharded_devices_match_one_device(n_dev, monkeypatch):
    """align_longread_sharded over 20 rows (three 8-row groups on the CPU
    rule) round-robins the groups over the devices; outputs equal the
    default (one device) call's, rows in order."""
    rng = np.random.default_rng(907)
    B, N, M = 20, 2048, 40
    template = rng.uniform(60, 120, M).astype(np.float32)
    signals = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for i in range(B):
        st = int(rng.integers(0, N - 2 * M))
        signals[i, st : st + M] = template + rng.normal(0, 0.5, M)
    n = torch.from_numpy(rng.integers(N - 3 * M, N, B).astype(np.int32))
    sig = torch.from_numpy(signals)
    ref = TA.align_longread_sharded(sig, n, template, AlignParams(), ckpt_steps=512)
    groups = []
    pass1 = TA._pass1_rows
    monkeypatch.setattr(TA, "_pass1_rows",
                        lambda s, *a, **k: groups.append(s.shape[0]) or pass1(s, *a, **k))
    got = TA.align_longread_sharded(sig, n, template, AlignParams(), devices=[CPU] * n_dev,
                                    ckpt_steps=512)
    assert groups == [8, 8, 8]
    for k in ("score", "j_end", "is_gap", "jpos", "j_begin"):
        assert torch.equal(got[k], ref[k]), k


# -- the CLI ------------------------------------------------------------------


@pytest.fixture(scope="module")
def run(model_file, tmp_path_factory):
    pm = PoreModel(model_file)
    r = write_count_run(tmp_path_factory.mktemp("run"), pm, RUN, 8, T_LOCI)
    r["expect"] = {rid: (t, s, n) for rid, (t, s, n) in r["reads"].items()}
    return r


def _count_args(run, model_file, out, extra=()):
    return ["count", run["fofn"], model_file, run["repeat"], "--algn", run["sam"],
            "--out", str(out), "--batch", "4", *extra]


@pytest.fixture(scope="module")
def single_tsv(run, model_file, tmp_path_factory):
    out = tmp_path_factory.mktemp("single") / "counts.tsv"
    assert cli.main(_count_args(run, model_file, out, ["--device", "cpu"])) == 0
    return out.read_text()


def _rows(text):
    return text.splitlines()[1:]


def test_count_devices_byte_identical(run, model_file, single_tsv, tmp_path):
    """``--devices 2`` writes ``--devices 1``'s TSV (the default here)
    and the JAX package's ``count``'s, byte for byte."""
    ref, got = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    assert jax_main(_count_args(run, model_file, ref)) == 0
    assert single_tsv == ref.read_text()
    assert cli.main(_count_args(run, model_file, got, ["--device", "cpu", "--devices", "2"])) == 0
    assert got.read_text() == single_tsv
    counted = {r.split("\t")[0]: (r.split("\t")[1], r.split("\t")[2], int(r.split("\t")[3]))
               for r in _rows(single_tsv)}
    assert counted == run["expect"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _hosts(run, model_file, out, n_hosts=2, extra=(), host_ids=None, port=None,
           prelude=""):
    """``count`` as ``n_hosts`` processes over gloo; [(rc, stderr)].
    ``prelude``: Python each process runs before the CLI."""
    port = port or _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    code = prelude + "\nimport sys\nfrom strique_tpu_torch.cli import main\nsys.exit(main())"
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, *_count_args(run, model_file, out),
         "--device", "cpu", "--coordinator", f"localhost:{port}", "--num_hosts", str(n_hosts),
         "--host_id", str(i), "--log_level", "info", *extra],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in (range(n_hosts) if host_ids is None else host_ids)]
    out_err = []
    for p in procs:
        try:
            _so, se = p.communicate(timeout=PROC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        out_err.append((p.returncode, se))
    return out_err


def test_count_two_hosts_merge_to_the_single_process_rows(run, model_file, single_tsv,
                                                          tmp_path):
    out = tmp_path / "out.tsv"
    logs = _hosts(run, model_file, out)
    for rc, err in logs:
        assert rc == 0, err[-2000:]
    # rank 0 merged the parts into one file after the barrier, parts gone
    assert out.exists()
    assert not any(tmp_path.glob("out.tsv.part*"))
    text = out.read_text()
    assert text.splitlines()[0] == single_tsv.splitlines()[0]
    assert sorted(_rows(text)) == sorted(_rows(single_tsv))
    ids = [r.split("\t")[0] for r in _rows(text)]
    assert sorted(ids) == sorted(set(ids)) == sorted(run["expect"])
    # the SAM stride split the reads between the ranks
    assert [err.count("Processed 2 alignments.") for _rc, err in logs] == [1, 1]


# the late rank's test: a rendezvous limit cut to LATE_TIMEOUT_S, and rank
# 1 starting its count LATE_BY_S after the rendezvous
LATE_TIMEOUT_S = 10
LATE_BY_S = 14
LATE_PRELUDE = f"""
import sys, time
from strique_tpu_torch.parallel import dispatcher, mesh
mesh.RENDEZVOUS_TIMEOUT_S = {LATE_TIMEOUT_S}
run_pipeline = dispatcher.run_pipeline
def late(*a, **k):
    if sys.argv[sys.argv.index("--host_id") + 1] == "1":
        time.sleep({LATE_BY_S})
    return run_pipeline(*a, **k)
dispatcher.run_pipeline = late
"""


def test_count_late_rank_still_merges(run, model_file, single_tsv, tmp_path):
    """Rank 1 reaches the end-of-run barrier LATE_BY_S after rank 0, past
    the rendezvous limit: the barrier waits for it (the limit holds the
    rendezvous only), and rank 0 merges the parts."""
    out = tmp_path / "out.tsv"
    logs = _hosts(run, model_file, out, prelude=LATE_PRELUDE)
    for rc, err in logs:
        assert rc == 0, err[-2000:]
    assert out.exists() and not any(tmp_path.glob("out.tsv.part*"))
    assert sorted(_rows(out.read_text())) == sorted(_rows(single_tsv))
    assert "merged 2 shards" in logs[0][1]


def test_count_two_hosts_resume(run, model_file, single_tsv, tmp_path):
    """A single process counts the first read; two processes resume: the
    rows before stay, every other read is counted once, by the stride."""
    out = tmp_path / "out.tsv"
    lines = open(run["sam"]).readlines()
    first = tmp_path / "first.sam"
    first.write_text("".join(lines[:2]))  # the header and the first read
    assert cli.main(_count_args(dict(run, sam=str(first)), model_file, out,
                                ["--device", "cpu"])) == 0
    before = out.read_text()
    logs = _hosts(run, model_file, out, extra=["--resume"])
    for rc, err in logs:
        assert rc == 0, err[-2000:]
    text = out.read_text()
    assert text.startswith(before)
    assert sorted(_rows(text)) == sorted(_rows(single_tsv))
    assert sum(err.count("Resuming; 1 reads already counted.") for _rc, err in logs) == 2


def test_count_failed_rendezvous_exits_non_zero(run, model_file, tmp_path):
    """Rank 0 whose coordinator address is taken: the rendezvous fails
    and the run exits non-zero without output (no single-process
    fallback)."""
    out = tmp_path / "out.tsv"
    with socket.socket() as busy:
        busy.bind(("localhost", 0))
        busy.listen(1)
        [(rc, err)] = _hosts(run, model_file, out, host_ids=[0],
                             port=busy.getsockname()[1])
    assert rc == 1
    assert "rendezvous failed" in err and "EADDRINUSE" in err
    assert not out.exists() and not any(tmp_path.glob("out.tsv.part*"))


# -- mesh -----------------------------------------------------------------------


def test_init_distributed_is_idempotent(monkeypatch):
    import torch.distributed as dist

    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    assert mesh.init_distributed() == 0 and not dist.is_initialized()  # a single process
    assert mesh.process_count() == 1
    mesh.barrier()
    try:
        assert mesh.init_distributed(f"localhost:{_free_port()}", 1, 0) == 0
        assert dist.is_initialized() and mesh.process_count() == 1
        # a second call returns the rank it joined with, whatever it asks
        assert mesh.init_distributed(f"localhost:{_free_port()}", 3, 2) == 0
        assert mesh.process_count() == 1
        mesh.barrier()
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="coordinator"):
        mesh.init_distributed("localhost:1", 2)


def test_init_distributed_from_the_environment(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    try:
        assert mesh.init_distributed() == 0
        assert dist.is_initialized() and mesh.process_count() == 1
    finally:
        dist.destroy_process_group()


def test_local_devices():
    assert mesh.local_devices("cpu") == [CPU]
    assert mesh.local_devices("cpu", "3") == [CPU] * 3
    assert mesh.shard_rows(24, 3) == [slice(0, 8), slice(8, 16), slice(16, 24)]
    assert mesh.shard_streams([CPU, CPU]) == [None, None]
    with pytest.raises(ValueError, match="equal shards"):
        mesh.shard_rows(10, 3)
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert len(mesh.local_devices("cuda")) == n
        assert len(mesh.local_devices("cuda", n + 3)) == n  # capped at the local count
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.local_devices("cuda")
