"""``cli.train --multihost`` on the CPU: 2 and 3 real processes over gloo,
each reading its shard of the synthetic store (``--feat_scale 16``, a
narrow net, batch 12, one epoch), must log identical metrics on every
rank, and at dropout 0 the single-process run's: the global-batch loss,
the agreed ``t_max`` and the gathered eval (3 ranks give ragged eval
shards: 64 clips) make the data-parallel epoch the single-process one.
Rank 0 alone writes the reference-format checkpoints, and ``cli.infer``
reproduces the MAE they recorded. ``--device cuda`` without a card
raises. (The baseline families with a batch-coupled ``model_loss``:
``test_torch_dp_model_loss.py``.)

Tolerance against the single process rtol 1e-4, with atol 1e-5 for the
correlation, which sits near 0 on a net one epoch old whose predictions
are nearly constant (the runs part at about 3e-6 there, at 1e-9 of the
MAE: the same rows, summed in another order). The CLI sets no dropout
rate (``--dropout`` is parsed, not read, as in the reference), so the
ranks run ``cli.train.main`` behind a two-line wrapper that sets the
model's rates to 0.
"""

import ast
import concurrent.futures
import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sdumc_tpu_torch.cli import common, infer, train
from sdumc_tpu_torch.data.collate import bucket_for
from sdumc_tpu_torch.parallel import (DataAxis, gather_rows, initialize_from_env,
                                      make_data_axis, pad_frames, process_metrics)
from sdumc_tpu_torch.train.step import step_seed

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ARGS = ["--synthetic", "--device", "cpu", "--feat_scale", "16", "--batch_size", "12",
        "--layers", "16,8"]
NO_DROPOUT = ("import functools, sys\n"
              "from sdumc_tpu_torch.cli import common, train\n"
              "common.ModelConfig = functools.partial(common.ModelConfig, dropout=0.0, "
              "attn_dropout=0.0)\n"
              "train.main(sys.argv[1:])\n")
WORLDS = (2, 3)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, argv, timeout: float = 300, attempts: int = 3, env=None):
    """Run `argv` (a python command line; ``{rank}`` in an argument becomes
    the rank) as `world` ranks on a free port, each with the SDUMC_*
    environment; retries on a fresh port when a group fails to form (a port
    taken meanwhile). Returns each rank's stdout."""
    err = ""
    for _ in range(attempts):
        port = _free_port()
        procs = []
        for rank in range(world):
            e = dict(os.environ, **(env or {}), SDUMC_COORDINATOR=f"127.0.0.1:{port}",
                     SDUMC_NUM_PROCESSES=str(world), SDUMC_PROCESS_ID=str(rank),
                     OMP_NUM_THREADS="1",
                     PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
            procs.append(subprocess.Popen([a.replace("{rank}", str(rank)) for a in argv],
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True, env=e, cwd=str(REPO)))
        outs, ok = [], True
        try:
            for p in procs:
                out, e = p.communicate(timeout=timeout)
                outs.append(out)
                if p.returncode != 0:
                    ok, err = False, e[-3000:]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if ok:
            return outs
    raise AssertionError(err)


def _logged(out: str) -> dict:
    """What a rank logged: the epoch line without its clips/s, and the two
    best-test dicts."""
    got = {}
    for line in out.splitlines():
        if line.startswith("epoch:"):
            got["epoch"] = line.rsplit(";", 1)[0]
        for key in ("best_test_full", "best_test_missing"):
            if line.startswith(key + ":"):
                got[key] = ast.literal_eval(line.split(":", 1)[1].strip())
    assert got.keys() == {"epoch", "best_test_full", "best_test_missing"}, out
    return got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-process run in this process, meanwhile the 2- and 3-rank
    groups, all at dropout 0; each rank with a checkpoint directory of its
    own."""
    work = tmp_path_factory.mktemp("multihost")

    def group(world):
        root = work / f"w{world}"
        argv = [sys.executable, "-c", NO_DROPOUT, "--multihost", "--data_parallel", str(world),
                "--epochs", "1", *ARGS, "--checkpoint_dir", str(root / "ck{rank}"),
                "--save_root", str(root / "saved{rank}")]
        return root, [_logged(o) for o in run_ranks(world, argv)]

    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        groups = {w: pool.submit(group, w) for w in WORLDS}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(common, "ModelConfig", functools.partial(
                common.ModelConfig, dropout=0.0, attn_dropout=0.0))
            single = train.main(ARGS + ["--epochs", "1", "--checkpoint_dir", str(work / "ck"),
                                        "--save_root", str(work / "saved")])
        return single, {w: f.result() for w, f in groups.items()}


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_logs_the_same_metrics(runs, world):
    _, groups = runs
    _, logs = groups[world]
    assert all(log == logs[0] for log in logs[1:]), logs


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_equal_the_single_process_run_at_dropout_0(runs, world):
    single, groups = runs
    log = groups[world][1][0]
    (h,) = single["history"]
    fields = dict(f.split(":") for f in log["epoch"].split("; "))
    for key in ("train_val_mse_full", "train_val_mse_missing"):   # logged to 4 decimals
        assert float(fields[key]) == pytest.approx(h[key.replace("_val", "")], abs=6e-5), key
    for view in ("full", "missing"):
        got, want = log[f"best_test_{view}"], single[f"best_{view}"]
        assert got.keys() == want.keys()
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-4,
                                             abs=1e-5 if key == "corr" else 0), (view, key)


@pytest.mark.parametrize("world", WORLDS)
def test_rank_0_alone_writes_reference_checkpoints_that_cli_infer_reads(runs, world):
    _, groups = runs
    root, logs = groups[world]
    assert sorted(os.listdir(root / "ck0")) == ["best_full.pt", "best_missing.pt", "latest.pt"]
    assert sorted(os.listdir(root)) == ["ck0", "saved0"]          # nothing of ranks 1..
    blob = torch.load(root / "ck0" / "best_full.pt", weights_only=True)
    assert not any(k.startswith("module.") for k in blob["state_dict"])
    out = infer.main(ARGS + ["--checkpoint", str(root / "ck0" / "best_full.pt")])
    assert out["full"]["mae"] == pytest.approx(logs[0]["best_test_full"]["mae"], rel=1e-6)


def test_multihost_on_cuda_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("SDUMC_COORDINATOR", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("SDUMC_NUM_PROCESSES", "2")
    monkeypatch.setenv("SDUMC_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--multihost", "--synthetic"])


def test_initialize_needs_the_environment(monkeypatch):
    for name in ("SDUMC_COORDINATOR", "SDUMC_NUM_PROCESSES", "SDUMC_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="SDUMC_COORDINATOR"):
        initialize_from_env(device="cpu")


@pytest.mark.parametrize("data_parallel,ok", [(-1, True), (1, True), (2, False), (0, False)])
def test_single_process_data_parallel_flag(data_parallel, ok):
    if ok:
        assert make_data_axis("cpu", data_parallel) == DataAxis()
    else:
        with pytest.raises(ValueError, match="--multihost"):
            make_data_axis("cpu", data_parallel)


def test_one_rank_gathers_and_reduces_nothing():
    x = torch.randn(3, 2, requires_grad=True)
    assert gather_rows(DataAxis(), x)[0] is x
    sums = {"loss": torch.tensor(2.0), "count": torch.tensor(3.0)}
    assert process_metrics(sums, DataAxis()) == {"loss": 2.0, "count": 3.0}


def test_pad_frames_reaches_the_global_bucket():
    buckets = (4, 8, 16)
    batch = {k: torch.ones(2, 4, 3) for k in ("audio", "text", "video", "feat4")}
    out = pad_frames(dict(batch, t_max=(3, 2, 4, 1)), (9, 2, 4, 1), buckets)
    assert out["t_max"] == (9, 2, 4, 1)
    assert out["audio"].shape == (2, bucket_for(9, buckets), 3)
    assert out["audio"][:, 4:].abs().sum() == 0 and out["audio"][:, :4].eq(1).all()
    assert all(out[k] is batch[k] for k in ("text", "video", "feat4"))


def test_step_seed_keeps_the_single_process_stream():
    """A single process keeps (seed, step); each rank draws its own."""
    hi, lo = np.random.SeedSequence([100, 7]).generate_state(2)
    assert step_seed(100, 7) == (int(hi) << 32) | int(lo)
    assert len({step_seed(100, 7), step_seed(100, 7, 0), step_seed(100, 7, 1)}) == 3


_SLEEP = [sys.executable, "-c", "import time; time.sleep(60)"]


def test_local_processes_stop_together(tmp_path):
    """A process that exits non-zero stops the others and raises with the
    end of its log; ``until`` returns while they run; a timeout stops them
    and raises; leaving the block kills what still runs."""
    from sdumc_tpu_torch.parallel.multihost import LocalProcesses

    with LocalProcesses() as procs:
        slow = procs.start("slow", _SLEEP)
        procs.start("bad", [sys.executable, "-c", "print('the end'); raise SystemExit(3)"],
                    log=str(tmp_path / "bad.log"))
        with pytest.raises(RuntimeError, match="bad exited with code 3; the others were "
                                               "stopped; its log ends:\nthe end"):
            procs.wait()
        assert slow.poll() is not None
    with LocalProcesses() as procs:
        slow = procs.start("slow", _SLEEP)
        procs.wait(until=lambda: True)
        assert slow.poll() is None
        with pytest.raises(RuntimeError, match="slow still running after 0.5 s"):
            procs.wait(timeout=0.5)
        assert slow.poll() is not None
    with LocalProcesses() as procs:
        slow = procs.start("slow", _SLEEP)
    assert slow.poll() is not None


def test_local_ranks_get_one_coordinator(tmp_path):
    """``start_ranks``: each rank its SDUMC_* environment around one free
    local port, the caller's variables, its own log."""
    from sdumc_tpu_torch.parallel.multihost import LocalProcesses

    show = ("import os; print(*(os.environ[k] for k in ('SDUMC_PROCESS_ID', "
            "'SDUMC_NUM_PROCESSES', 'SDUMC_COORDINATOR', 'EXTRA')))")
    with LocalProcesses() as procs:
        procs.start_ranks([sys.executable, "-c", show], 2, env={"EXTRA": "x"},
                          log_dir=str(tmp_path))
        procs.wait(timeout=60)
    logs = [(tmp_path / f"rank{r}.log").read_text().split() for r in range(2)]
    assert [g[:2] for g in logs] == [["0", "2"], ["1", "2"]]
    assert logs[0][2] == logs[1][2] and logs[0][2].startswith("127.0.0.1:")
    assert logs[0][3] == logs[1][3] == "x"
