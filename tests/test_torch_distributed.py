"""Multi-process runs of the port's ``parallel`` package on the CPU (gloo).

Mirrors tests/test_distributed.py: real OS processes (not forks of this
process, which has JAX loaded), rendezvous through a ``FileStore`` file
under ``tmp_path`` so that parallel test workers never race for a port, each
launch with a timeout of its own. Held: the distributed smoke's two ranks
agree (loss, global sum, parameter digest) and agree with one process's step
on the concatenated batch; ``dryrun 2 --device cpu`` passes; a rank whose
peers never arrive raises instead of training alone; ``train`` without a
launcher has no mesh.
"""

import os
import subprocess
import sys

import numpy as np
import torch

from heybuddy_tpu_torch.parallel import distributed_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("PYTEST_CURRENT_TEST", "WORLD_SIZE", "RANK")}
    env.update(OMP_NUM_THREADS="1", HEYBUDDY_OFFLINE="1")
    return env


def _run_all(commands, timeout):
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env(),
                              cwd=REPO) for cmd in commands]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outputs


def test_two_rank_train_step(tmp_path):
    rendezvous = f"file://{tmp_path / 'rendezvous'}"
    rcs, outputs = _run_all(
        [[sys.executable, "-m", "heybuddy_tpu_torch.parallel.distributed_smoke", str(pid), "2", rendezvous,
          "--device", "cpu", "--out", str(tmp_path / f"rank{pid}.npz")] for pid in range(2)],
        timeout=120,
    )
    markers = []
    for pid, (rc, out) in enumerate(zip(rcs, outputs)):
        lines = [line for line in out.splitlines() if "DISTRIBUTED-SMOKE-OK" in line]
        assert rc == 0 and lines, f"rank {pid} failed (rc={rc}):\n{out[-3000:]}"
        markers.append(lines[0])
    # the global batch mixes rows only one rank drew: agreement needs the all_reduce
    fields = [dict(kv.split("=") for kv in m.split()[1:]) for m in markers]
    assert [f["pid"] for f in fields] == ["0", "1"]
    for key in ("loss", "gsum", "digest"):
        assert fields[0][key] == fields[1][key], markers

    # one process's step on the concatenated batch: the same step, summed in another order
    ranks = [np.load(tmp_path / f"rank{pid}.npz") for pid in range(2)]
    assert not np.array_equal(ranks[0]["x"], ranks[1]["x"])
    x = torch.from_numpy(np.concatenate([r["x"] for r in ranks]))
    y = torch.from_numpy(np.concatenate([r["y"] for r in ranks]))
    model, loss, gsum = distributed_smoke.smoke_step(x, y)
    np.testing.assert_allclose(float(ranks[0]["loss"]), loss, rtol=1e-6)
    np.testing.assert_allclose(float(ranks[0]["gsum"]), gsum, rtol=1e-6)
    # the trainer's parameter rule (tests/test_torch_trainer.py): Adam's first
    # step divides each gradient element by its own size, so an element whose
    # gradient sits near float32 rounding moves a different share of a step
    got = np.concatenate([ranks[0][f"param/{name}"].ravel() for name, _ in model.named_parameters()])
    want = np.concatenate([p.detach().numpy().ravel() for _, p in model.named_parameters()])
    err = np.abs(got - want)
    assert np.mean(err <= 1e-5 + 1e-4 * np.abs(want)) >= 0.99 and err.max() <= 2e-4, err.max()


def test_dryrun_two_ranks_on_the_cpu():
    rcs, outputs = _run_all(
        [[sys.executable, "-m", "heybuddy_tpu_torch.parallel.dryrun", "2", "--device", "cpu"]], timeout=300)
    out = outputs[0]
    assert rcs == [0], out[-4000:]
    assert "dryrun(2): OK" in out
    for rank in range(2):
        assert f"[dryrun rank {rank}] production trainer over 2 ranks OK" in out
        assert f"[dryrun rank {rank}] sharded contrastive pretrain steps over 2 ranks OK" in out


def test_a_rank_without_its_peers_raises(tmp_path):
    """One of two ranks, its peer never started: ``init_process_group`` times
    out and raises; nothing falls back to training alone."""
    code = (
        "import datetime\n"
        "from heybuddy_tpu_torch.parallel.mesh import distributed_init\n"
        f"distributed_init('file://{tmp_path / 'rendezvous'}', 2, 0, device='cpu',"
        " timeout=datetime.timedelta(seconds=3))\n"
        "print('JOINED')\n"
    )
    rcs, outputs = _run_all([[sys.executable, "-c", code]], timeout=120)
    assert rcs[0] != 0 and "JOINED" not in outputs[0], outputs[0][-2000:]


def test_train_without_a_launcher_has_no_mesh(monkeypatch):
    """``train --mesh`` (the default) takes effect only above one rank, as
    JAX's device_count() > 1 check."""
    from heybuddy_tpu_torch.cli import build_parser
    from heybuddy_tpu_torch.parallel.mesh import world_size

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = build_parser().parse_args(["train", "hey buddy"])
    assert args.mesh is True and world_size() == 1
    assert build_parser().parse_args(["extract", "n", "s"]).mesh is False
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert world_size() == 4
