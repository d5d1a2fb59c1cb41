"""The port's mesh (``heybuddy_tpu_torch.parallel``) against the JAX package's, on the CPU.

Mirrors tests/test_mesh.py. The ranks are processes of their own
(tests/torch_mesh_ranks.py, the port only) on gloo, meeting through a
``FileStore`` file under the module's temporary directory, started before the
references are computed here and joined with a timeout of their own. Held:
``pad_batch_to_multiple`` bit for bit; the trainer at 3 ranks on batches whose
rows do not divide by 3 (24 train steps, then two stages through the
device-resident path with evaluation) against JAX's
``WakeWordTrainer(mesh=get_mesh(data=3))`` and the port at one rank;
``SpeechEmbeddings(mesh)`` and ``extract --mesh`` at 2 ranks against one rank
and JAX's mesh; one float32 pretrain step at 2 ranks (b = 4, 9 texts, JAX's
draws injected) against one rank, with the unscaled W-times gradient as the
control that must fail, and the bf16 step against JAX's mesh step; a DCP save
and resume at 2 ranks; ``train --mesh`` at 2 ranks on an unseeded
``--training-dataset``: the ranks' index streams equal each other and the
one-rank run's given rank 0's seed, and on the threaded host path every rank
trains on rank 0's batches.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from types import SimpleNamespace

from heybuddy_tpu.data.augmented import NoiseProvider as JaxNoiseProvider
from heybuddy_tpu.models import embedding_net as jax_net
from heybuddy_tpu.models.featurizer import SpeechEmbeddings as JaxSpeechEmbeddings
from heybuddy_tpu.parallel import mesh as jax_mesh
from heybuddy_tpu.training import embedding_pretrain as jax_pretrain
from heybuddy_tpu.training import trainer as jax_trainer
from heybuddy_tpu_torch.cli import main as cli_main
from heybuddy_tpu_torch.data.space import active_space, write_space_sidecar
from heybuddy_tpu_torch.models.featurizer import SpeechEmbeddings
from heybuddy_tpu_torch.parallel import mesh
from heybuddy_tpu_torch.training import trainer
from heybuddy_tpu_torch.utils.audio_io import write_wav

import torch_mesh_ranks as ranks
from test_torch_pretrain import _jax_draw_pair, _speech_pool

# the trainer's rules (tests/test_torch_trainer.py): histories rtol 1e-4; the
# parameters 1e-5 + 1e-4 |x| for 99% of the elements and 2e-4 for all
HISTORY_RTOL, HISTORY_ATOL = 1e-4, 1e-7
PARAM_ATOL, PARAM_RTOL, PARAM_SHARE, PARAM_MAX = 1e-5, 1e-4, 0.99, 2e-4
# the featurizer at 2 ranks against one: each clip is featurized alone, so
# only the plain versions' float32 matmuls over another batch size move a value
FEATURE_ATOL = 1e-6
# extract's last batch puts one row on each rank, and the plain versions'
# float32 matmuls on the CPU sum a batch of one row in another order than a
# larger batch (3.7e-5 measured at 1 row against 2 or 4); on a card each
# clip is one block of the kernels and chip_smoke holds the shards bit for bit
EXTRACT_FEATURE_ATOL = 1e-4
# against JAX's mesh featurizer in float32 (its banded XLA path on the CPU):
# the featurizer rule, the port's bf16 path against the float32 reference
# (tests/test_torch_featurizer.py)
JAX_FEATURE_ATOL = 0.1
# the float32 pretrain step at 2 ranks against one (chip_smoke's pretrain limits)
PRETRAIN_LOSS_RTOL, PRETRAIN_GRAD_TOL = 1e-5, 2e-5
# the bf16 step against JAX's jitted step (tests/test_torch_pretrain.py)
PRETRAIN_BF16_RTOL = 1.25 * 6.0e-3
RANKS_TIMEOUT = 240  # seconds for every rank of a launch

SIZES = [40, 41, 40, 40, 160, 41, 25, 24, 160, 161, 40, 40, 41, 40, 40, 160, 25, 24, 24, 25, 40, 41, 160, 40]
PATTERN = np.sign(np.sin(np.arange(16 * 96))).reshape(16, 96).astype(np.float32)
B, N_TEXTS = 4, 9


def _batches(sizes, seed=0, amplitude=0.3):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        h = n // 2
        x = rng.normal(0.0, 1.0, (n, 16, 96)).astype(np.float32)
        x[:h] += amplitude * PATTERN
        x[h:] -= amplitude * PATTERN
        out.append((x, np.concatenate([np.ones(h), np.zeros(n - h)]).astype(np.float32)))
    return out


def _write_inputs(workdir):
    """Every rank's inputs; returns what the references here need."""
    jmesh3 = jax_mesh.get_mesh(data=3)
    jax_t = jax_trainer.WakeWordTrainer(checkpoint_dir=workdir, mesh=jmesh3, **ranks.TRAIN_KW)
    jax_t.save_checkpoint("init")
    batches = _batches(SIZES)
    np.savez(os.path.join(workdir, "batches.npz"),
             **{f"{k}{i}": a for i, (x, y) in enumerate(batches) for k, a in (("x", x), ("y", y))})
    rng = np.random.default_rng(4)
    np.savez(os.path.join(workdir, "pools.npz"),
             **{name: (rng.normal(0.0, 1.0, (n, 16, 96)) + sign * PATTERN).astype(np.float32)
                for name, n, sign in (("pos", 50, 1.0), ("neg", 60, -1.0), ("neg2", 91, 0.25))})
    clips = (rng.normal(0, 0.03, (5, 23040)) * 32767).astype(np.float32) / 32767.0
    np.save(os.path.join(workdir, "clips.npy"), clips)
    os.makedirs(os.path.join(workdir, "wavs"))
    for i in range(3):
        write_wav(os.path.join(workdir, "wavs", f"clip{i}.wav"), rng.normal(0, 0.05, 30000 + 7000 * i).astype(np.float32))
        with open(os.path.join(workdir, "wavs", f"clip{i}.txt"), "w") as f:
            f.write(f"hello world {i}")

    streams_dir = os.path.join(workdir, "streams-data")
    os.makedirs(streams_dir)
    space = active_space(device="cpu")
    for name, n, sign in (("hey-buddy", 40, 1.0), ("hey-buddy-adversarial", 40, -1.0),
                          ("custom-negatives", ranks.STREAM_CUSTOM_ROWS, -0.5)):
        path = os.path.join(streams_dir, f"{name}.npy")
        np.save(path, (rng.normal(0.0, 1.0, (n, 16, 96)) + sign * PATTERN).astype(np.float32))
        write_space_sidecar(path, space)

    ref = jax_pretrain.EmbeddingPretrainer(texts=[f"text {i}" for i in range(N_TEXTS)], speakers_per_text=2,
                                           batch_size=B, seed=0, mesh=jax_mesh.get_mesh(data=2))
    jax_net.save_params(ref.params, os.path.join(workdir, "pretrain-init.npz"))
    pool, lengths = _speech_pool(n_texts=N_TEXTS)
    text_idx = rng.choice(N_TEXTS, size=B, replace=False)
    pair_mask = np.zeros((B, B), bool)
    pair_mask[0, 1] = pair_mask[1, 0] = True
    key = jax.random.fold_in(jax.random.PRNGKey(13), 0)
    draws = _jax_draw_pair(key, ref.augment_config)
    batch = dict(text_idx=text_idx, spk_idx=np.stack([rng.choice(2, size=2, replace=False) for _ in range(B)]),
                 noise_idx=rng.integers(0, 256, (2, B)), imp_idx=rng.integers(0, 64, (2, B)), pair_mask=pair_mask)
    np.savez(os.path.join(workdir, "pretrain.npz"), pool=pool, lengths=lengths, **batch,
             **{f"draw{v}/{k}": t.numpy() for v in range(2) for k, t in draws[v].items()})
    return {"jax_trainer": jax_t, "batches": batches, "clips": clips, "pretrain_ref": ref, "pretrain_key": key,
            "pretrain_batch": batch, "pool": pool, "lengths": lengths}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs, the ranks' outputs (rank 0's) and the references computed here."""
    workdir = str(tmp_path_factory.mktemp("mesh"))
    inputs = _write_inputs(workdir)
    launches = [ranks.Ranks(workdir, 3, "trainer"), ranks.Ranks(workdir, 2, "featurize,extract,dcp,pretrain,streams")]
    refs = {"inputs": inputs, "workdir": workdir}
    # the port at one rank, while the ranks run
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs["steps"] = ranks.train_steps(workdir)
        refs["resident"] = ranks.resident_run(workdir)
        refs["pretrain"] = ranks.pretrain(workdir)
        refs["featurize"] = SpeechEmbeddings(device="cpu")(inputs["clips"])
        one_rank_dir = os.path.join(workdir, "shards-one")
        assert cli_main(["extract", "noise", os.path.join(workdir, "wavs", "*.wav"), "--local-files",
                         "--directory", one_rank_dir, "--process-batch-size", "4", "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(threads)
    refs["extract_dir"] = one_rank_dir
    outputs = [launch.wait(RANKS_TIMEOUT) for launch in launches]
    refs["outputs"] = outputs
    for scenario in ("trainer", "featurize", "extract", "dcp", "pretrain", "streams"):
        refs[scenario + "_ranks"] = [dict(np.load(os.path.join(workdir, f"{scenario}-{r}.npz")))
                                     for r in range(3 if scenario == "trainer" else 2)]
    # the one-rank run given the seed rank 0 drew (none where each rank drew its own)
    seeds = refs["streams_ranks"][0]["resident/seed"]
    refs["streams"] = ranks.index_streams(workdir, seed=int(seeds[0])) if seeds.size else None
    return refs


def _params_close(got, ref):
    err = np.abs(got - ref)
    return float(np.mean(err <= PARAM_ATOL + PARAM_RTOL * np.abs(ref))), float(err.max())


def _jax_flat(params):
    return np.concatenate([np.asarray(leaf).reshape(-1) for leaf in jax.tree_util.tree_leaves(params)])


@pytest.mark.parametrize("shape,multiple,dtype", [((5, 3), 8, np.float32), ((8, 3), 8, np.float32),
                                                   ((7, 16, 96), 3, np.float32), ((0, 4), 2, np.int64),
                                                   ((9,), 4, np.float16)])
def test_pad_batch_to_multiple_bit_equal_jax(shape, multiple, dtype):
    batch = np.random.default_rng(0).normal(size=shape).astype(dtype)
    got, n = mesh.pad_batch_to_multiple(batch, multiple)
    want, n_ref = jax_mesh.pad_batch_to_multiple(batch, multiple)
    assert n == n_ref == shape[0] and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes() and got.shape == want.shape


def test_row_ranges_shard_batch_and_placements():
    rows = [mesh.row_range(7, SimpleNamespace(size=3, rank=r)) for r in range(3)]
    assert rows == [(0, 3, 3), (3, 6, 3), (6, 7, 3)]
    assert mesh.row_range(2, SimpleNamespace(size=3, rank=2)) == (2, 2, 1)
    batch = np.arange(12.0).reshape(6, 2)
    fake = SimpleNamespace(size=3, rank=1, device=torch.device("cpu"))
    np.testing.assert_array_equal(mesh.shard_batch(batch, fake).numpy(), batch[2:4])
    np.testing.assert_array_equal(mesh.shard_batch(batch, fake, process_local=True).numpy(), batch)
    with pytest.raises(ValueError, match="do not divide"):
        mesh.shard_batch(batch[:5], fake)
    assert type(mesh.batch_sharding(fake)[0]).__name__ == "Shard"
    assert type(mesh.replicated(fake)[0]).__name__ == "Replicate"
    assert mesh.world_size() == int(os.environ.get("WORLD_SIZE", "1")) and not torch.distributed.is_initialized()


def test_train_steps_at_three_ranks_match_jax_mesh(run):
    """24 steps on batches of 24-161 rows (most not a multiple of 3), padded with -1 rows."""
    jax_t, batches = run["inputs"]["jax_trainer"], run["inputs"]["batches"]
    thr, act = ranks.THRESHOLDS
    jax_step = jax_t._build_train_step(thr, act)
    params, opt_state, carry = jax_t.model.params, jax_t.opt_state, jax_trainer._init_carry()
    ref = []
    for i, (x, y) in enumerate(batches):
        lr, nw = ranks.step_schedule(i)
        params, opt_state, carry, m = jax_step(params, opt_state, carry, *jax_t._device_put_batch(x, y),
                                               jax.random.PRNGKey(1), np.int32(i), np.float32(lr), np.float32(nw))
        ref.append(np.asarray(m))
    ref = np.stack(ref)
    got = run["trainer_ranks"]
    for r in range(3):  # every rank holds the same values
        np.testing.assert_array_equal(got[r]["steps/metrics"], got[0]["steps/metrics"])
        np.testing.assert_array_equal(got[r]["steps/flat"], got[0]["steps/flat"])
    m = got[0]["steps/metrics"]
    np.testing.assert_array_equal(m[:, 4], ref[:, 4])  # did_step
    np.testing.assert_array_equal(m[:, 5], ref[:, 5])  # n_hard
    np.testing.assert_array_equal(m[:, 1], ref[:, 1])  # n_hard over the padded batch
    assert (ref[:, 4] == 0).any() and (ref[:, 4] == 1).any() and ((ref[:, 5] >= 128) & (ref[:, 4] == 1)).any()
    np.testing.assert_allclose(m[:, :4], ref[:, :4], rtol=HISTORY_RTOL, atol=HISTORY_ATOL)
    share, worst = _params_close(got[0]["steps/flat"], _jax_flat(params))
    assert share >= PARAM_SHARE and worst <= PARAM_MAX, (share, worst)
    assert int(got[0]["steps/count"]) == int(jax.tree_util.tree_leaves(opt_state)[0])


def test_train_steps_at_three_ranks_match_one_rank(run):
    got, one = run["trainer_ranks"][0], run["steps"]
    np.testing.assert_array_equal(got["steps/metrics"][:, 4:], one["metrics"][:, 4:])
    reciprocal = np.array([1.0 / (-(-n // 3) * 3) for n in SIZES]).astype(np.float32)  # over the padded batch
    np.testing.assert_array_equal(got["steps/metrics"][:, 1], one["metrics"][:, 5] * reciprocal)
    for col in (0, 2, 3):  # loss, recall, fp rate
        np.testing.assert_allclose(got["steps/metrics"][:, col], one["metrics"][:, col], rtol=HISTORY_RTOL,
                                   atol=HISTORY_ATOL)
    share, worst = _params_close(got["steps/flat"], one["flat"])
    assert share >= PARAM_SHARE and worst <= PARAM_MAX, (share, worst)
    # a 2-row pool scored and counted over 3 ranks, one of which holds no row
    assert got["steps/tiny_scores"].shape == (2,)
    np.testing.assert_allclose(got["steps/tiny_scores"], one["tiny_scores"], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got["steps/tiny_counts"], one["tiny_counts"])
    assert got["steps/tiny_counts"].sum() > 0


def test_resident_stages_at_three_ranks_match_one_rank(run):
    """Two stages of the resident path (89 rows a step), evaluated every 3
    steps on resident validation pools (50 / 60 / 91 rows), the negative
    weight moved by the evaluation: the same history as one rank's, the
    high-loss rate over 90 padded rows."""
    got = run["trainer_ranks"][0]
    one = run["resident"]
    for key in ("learning_rate", "negative_weight", "validation_false_positive_per_hour", "validation_recall"):
        np.testing.assert_array_equal(got[f"resident/history/{key}"], one[f"history/{key}"], err_msg=key)
    for key in ("loss", "recall", "false_positive_rate"):
        np.testing.assert_allclose(got[f"resident/history/{key}"], one[f"history/{key}"], rtol=HISTORY_RTOL,
                                   atol=HISTORY_ATOL, err_msg=key)
    np.testing.assert_allclose(got["resident/history/high_loss_rate"] * 90, one["history/high_loss_rate"] * 89,
                               rtol=1e-6)
    assert got["resident/history/loss"].shape == (16,)
    assert np.ptp(got["resident/history/validation_recall"]) > 0  # the evaluation's counts move
    share, worst = _params_close(got["resident/flat"], one["flat"])
    assert share >= PARAM_SHARE and worst <= PARAM_MAX, (share, worst)
    for r in (1, 2):
        np.testing.assert_array_equal(run["trainer_ranks"][r]["resident/flat"], got["resident/flat"])


def test_speech_embeddings_mesh_matches_one_rank_and_jax(run):
    """5 clips over 2 ranks: 3 rows on rank 0, 2 and a zero clip on rank 1."""
    one = run["featurize"]
    for out in run["featurize_ranks"]:
        assert out["call"].shape == (5, 16, 96) and int(out["n"]) == 5
        np.testing.assert_allclose(out["call"], one, atol=FEATURE_ATOL, rtol=0)
        np.testing.assert_array_equal(out["device"], out["call"])
    jax_out = JaxSpeechEmbeddings(mesh=jax_mesh.get_mesh(data=2), compute_dtype=jnp.float32)(run["inputs"]["clips"])
    assert jax_out.shape == (5, 16, 96)
    assert np.abs(run["featurize_ranks"][0]["call"] - jax_out).max() < JAX_FEATURE_ATOL


def test_extract_mesh_writes_the_one_rank_shards(run):
    """``extract --mesh`` at 2 ranks (6 clips in batches of 4 and 2): rank 0
    writes the one-rank run's shards: the same files, header bytes and token
    rows bit for bit, the features within EXTRACT_FEATURE_ATOL (the last
    batch puts one row on each rank)."""
    shards = [str(p) for p in run["extract_ranks"][0]["shards"]]
    assert [int(out["rc"]) for out in run["extract_ranks"]] == [0, 0]
    one = sorted(os.listdir(run["extract_dir"]))
    assert [os.path.basename(p) for p in shards] == one and one
    for path in shards:
        other = os.path.join(run["extract_dir"], os.path.basename(path))
        got, want = np.load(path), np.load(other)
        assert got.shape == want.shape and got.shape[1:] == (17, 96) and got.shape[0] == 6
        with open(path, "rb") as a, open(other, "rb") as b:
            head = len(a.read()) - got.nbytes
            a.seek(0)
            assert a.read(head) == b.read(head)
        np.testing.assert_array_equal(got[:, 16], want[:, 16])
        np.testing.assert_allclose(got[:, :16], want[:, :16], atol=EXTRACT_FEATURE_ATOL, rtol=0)


def _grad_gap(got, ref):
    return float(np.abs(got - ref).max() / np.linalg.norm(ref.astype(np.float64)))


def test_pretrain_step_at_two_ranks_matches_one_rank(run):
    """One float32 step (b = 4, 9 texts: the pool padded to 10, 5 on each
    rank): loss and gradient within chip_smoke's limits of one rank's, and the
    gradient without the division by W (the gathers' backward sums 2 equal
    upstream gradients) outside them."""
    one = run["pretrain"]
    for out in run["pretrain_ranks"]:
        rel = np.abs(out["loss"] - one["loss"]) / np.maximum(np.abs(one["loss"]), 1e-12)
        assert rel[:2].max() <= PRETRAIN_LOSS_RTOL, (out["loss"], one["loss"])
        assert abs(out["loss"][2] - one["loss"][2]) <= PRETRAIN_LOSS_RTOL * max(abs(one["loss"][2]), 1.0)
        assert _grad_gap(out["grad"], one["grad"]) <= PRETRAIN_GRAD_TOL
        control = _grad_gap(out["grad_unscaled"], one["grad"])
        assert control > 100 * PRETRAIN_GRAD_TOL, control  # an unscaled gradient fails the limit
    assert one["loss"][2] > 0.0  # the masked pair sits above the margin


def test_pretrain_step_at_two_ranks_matches_jax_mesh(run):
    """The bf16 step at 2 ranks against JAX's jitted step over a 2-device mesh
    (the pool padded to 10 texts and sharded), by the jitted-step rule."""
    inputs = run["inputs"]
    ref, batch = inputs["pretrain_ref"], inputs["pretrain_batch"]
    pool = np.concatenate([inputs["pool"], np.zeros_like(inputs["pool"][:1])])
    lengths = np.concatenate([inputs["lengths"], np.ones_like(inputs["lengths"][:1])])
    provider = JaxNoiseProvider(seed=0, use_remote=False)
    params = jax.tree_util.tree_map(jnp.array, ref.params)
    _, _, metrics = ref._build_step()(
        params, ref.tx.init(params), pool, lengths, provider.noise_batch(256), provider.impulse_batch(64),
        jnp.stack([inputs["pretrain_key"]]),
        *(np.asarray(batch[k])[None].astype(np.int32) for k in ("text_idx", "spk_idx", "noise_idx", "imp_idx")),
        batch["pair_mask"][None],
    )
    for out in run["pretrain_ranks"]:
        np.testing.assert_allclose(out["bf16_metrics"], np.asarray(metrics)[0], rtol=PRETRAIN_BF16_RTOL)


def test_dcp_save_and_resume_at_two_ranks(run):
    for out in run["dcp_ranks"]:
        np.testing.assert_array_equal(out["restored"], out["saved"])
        assert out["count"][0] == out["count"][1] > 0 and float(out["moved"]) > 0
        assert "mesh_dcp" in set(out["files"]) and "mesh.npz" in set(out["files"])
    np.testing.assert_array_equal(run["dcp_ranks"][1]["saved"], run["dcp_ranks"][0]["saved"])


def test_orbax_backend_raises_and_names_dcp(tmp_path):
    with pytest.raises(ValueError, match="dcp"):
        trainer.WakeWordTrainer(checkpoint_dir=str(tmp_path), device="cpu", checkpoint_backend="orbax")
    with pytest.raises(ValueError, match="checkpoint_backend"):
        trainer.WakeWordTrainer(checkpoint_dir=str(tmp_path), device="cpu", checkpoint_backend="zarr")


def test_train_mesh_draws_one_index_stream(run):
    """``train --mesh`` at 2 ranks on an unseeded ``--training-dataset`` (300
    rows, 1000 a step: it wraps and reshuffles within every step) through the
    device-resident path: rank 0 draws one seed, every rank serves the same
    index vector for all 24 steps, the same as the one-rank run given that
    seed, and ends within the trainer's rules of it."""
    r0, r1 = run["streams_ranks"]
    indices = r0["resident/indices"]
    assert indices.shape == (ranks.STREAM_STEPS, 8 + 8 + 1000)
    for step in range(ranks.STREAM_STEPS):
        np.testing.assert_array_equal(r1["resident/indices"][step], indices[step], err_msg=f"step {step}")
    assert r0["resident/seed"].shape == (1,) and r1["resident/seed"].tolist() == r0["resident/seed"].tolist()
    one = run["streams"]
    np.testing.assert_array_equal(one["resident/indices"], indices)
    custom = indices[:, 16:]
    assert np.ptp(custom, axis=0).max() > 0  # the unseeded set's draws move from step to step
    share, worst = _params_close(r0["resident/flat"], one["resident/flat"])
    assert share >= PARAM_SHARE and worst <= PARAM_MAX, (share, worst)


def test_train_mesh_threaded_host_path_serves_rank_zeros_batches(run):
    """The threaded host path (HEYBUDDY_DEVICE_DATA=0, 2 producer threads,
    whose batch order follows their timing): every rank trains on rank 0's
    batches, row for row, in all 24 steps."""
    r0, r1 = run["streams_ranks"]
    rows, labels = r0["threaded/rows"], r0["threaded/labels"]
    assert rows.shape == (ranks.STREAM_STEPS, 1016)
    np.testing.assert_array_equal(r1["threaded/rows"], rows)
    np.testing.assert_array_equal(r1["threaded/labels"], labels)
    np.testing.assert_array_equal(labels, np.tile(np.repeat([1.0, 0.0], [8, 1008]), (ranks.STREAM_STEPS, 1)))
    assert r0["threaded/seed"].shape == (1,) and r1["threaded/seed"].tolist() == r0["threaded/seed"].tolist()
