"""The reference's substrate tests (tests/test_substrate.py) run on the
port, on the CPU: the data pipeline's determinism, resharding, resume and
prefetch; checkpoint atomicity, retention, the torn-write fallback and the
asynchronous commit; AdamW's math and clipping; the cosine schedule; int8
quantization and error feedback; the elastic planner and straggler
monitor; the train driver's decreasing loss and its restart. Plus what the
port adds to them: an asynchronous save whose tree is updated in place at
once still writes the values it was given, checkpoints of the LM driver
cross to the reference's layout, and the driver without a device asks for
CUDA.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint import load_reference_checkpoint  # noqa: E402
from repro_torch.data import SyntheticLMPipeline  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, cosine_schedule)
from repro_torch.optim.compress import (compress_grads,  # noqa: E402
                                        dequantize_int8, quantize_int8)
from repro_torch.runtime import ElasticPlanner, StragglerMonitor  # noqa: E402
from repro_torch.tree import flatten, tree_map  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on one host, and torch's default (every core in each)
    oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ data
def test_pipeline_deterministic():
    def mk():
        return SyntheticLMPipeline(vocab_size=512, seq_len=64,
                                   global_batch=8, seed=3,
                                   n_logical_shards=8)
    a, b = mk(), mk()
    for _ in range(3):
        ba, bb = next(a), next(b)
        np.testing.assert_array_equal(ba["tokens"], bb["tokens"])


def test_pipeline_reshard_partitions_batch():
    """Two half-range pipelines concatenate to the full batch at any step."""
    full = SyntheticLMPipeline(vocab_size=512, seq_len=32, global_batch=8,
                               seed=1, n_logical_shards=8, shard_range=(0, 8))
    lo = full.reshard((0, 4))
    hi = full.reshard((4, 8))
    f = full.batch_at(5)["tokens"]
    np.testing.assert_array_equal(
        np.concatenate([lo.batch_at(5)["tokens"], hi.batch_at(5)["tokens"]]),
        f)


def test_pipeline_resume_from_state():
    p = SyntheticLMPipeline(vocab_size=128, seq_len=16, global_batch=4,
                            seed=0, n_logical_shards=4)
    batches = [next(p) for _ in range(4)]
    q = SyntheticLMPipeline(vocab_size=128, seq_len=16, global_batch=4,
                            seed=0, n_logical_shards=4)
    q.state.step = 2
    np.testing.assert_array_equal(next(q)["tokens"], batches[2]["tokens"])


def test_pipeline_prefetch_matches_sync():
    p = SyntheticLMPipeline(vocab_size=128, seq_len=16, global_batch=4,
                            seed=9, n_logical_shards=4)
    sync = [p.batch_at(i)["tokens"] for i in range(3)]
    p.start_prefetch()
    try:
        for i in range(3):
            np.testing.assert_array_equal(next(p)["tokens"], sync[i])
    finally:
        p.stop_prefetch()


def test_pipeline_equals_reference():
    """The copy's batches are the reference pipeline's, byte for byte."""
    from repro.data import SyntheticLMPipeline as JPipeline
    kw = dict(vocab_size=1000, seq_len=48, global_batch=4, seed=2,
              n_logical_shards=4)
    a, b = SyntheticLMPipeline(**kw), JPipeline(**kw)
    for step in (0, 7):
        for k in ("tokens", "loss_mask"):
            np.testing.assert_array_equal(a.batch_at(step)[k],
                                          b.batch_at(step)[k])


# ------------------------------------------------------------------ ckpt
def test_checkpoint_roundtrip_and_retention(tmp_path):
    ck = Checkpointer(tmp_path, keep_last=2)
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "opt": {"m": torch.ones(3)}}
    for s in (10, 20, 30):
        t = tree_map(lambda x: x + s, tree)
        ck.save(s, t, extra={"data_step": s})
    assert ck.steps() == [20, 30]
    restored, step, extra = ck.restore(tree)
    assert step == 30 and extra["data_step"] == 30
    torch.testing.assert_close(restored["w"], tree["w"] + 30)


def test_checkpoint_torn_write_falls_back(tmp_path):
    ck = Checkpointer(tmp_path, keep_last=5)
    tree = {"w": torch.ones(4)}
    ck.save(1, tree)
    ck.save(2, tree_map(lambda x: x * 2, tree))
    # corrupt step 2: flip bytes in the array file
    d = tmp_path / "step_00000002"
    f = next(d.glob("*.npy"))
    raw = bytearray(f.read_bytes())
    raw[-4] ^= 0xFF
    f.write_bytes(bytes(raw))
    restored, step, _ = ck.restore(tree)
    assert step == 1                       # checksum mismatch -> fallback
    torch.testing.assert_close(restored["w"], tree["w"])


def test_checkpoint_async_commit(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = {"w": torch.zeros(8)}
    assert ck.save(5, tree, blocking=False)
    assert ck.next_step() == 6             # in flight counts
    ck.wait()
    assert ck.steps() == [5]
    assert not ck.save(5, tree, blocking=False)     # already committed


def test_async_save_snapshots_before_an_inplace_step(tmp_path):
    """An asynchronous save followed at once by an in-place AdamW step on
    the same CPU tensors restores the values of before the step: the
    save copies every leaf before its thread starts."""
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.standard_normal(
        (256, 64)).astype(np.float32)), "b": torch.zeros(64)}
    opt = adamw_init(params)
    grads = tree_map(lambda p: torch.ones_like(p), params)
    adamw_update(params, grads, opt, AdamWConfig(lr=1e-2))
    before = tree_map(torch.clone, [params, opt])
    ck = Checkpointer(tmp_path)
    ck.save(1, [params, opt], blocking=False)
    for _ in range(3):
        adamw_update(params, grads, opt, AdamWConfig(lr=1e-2))
    assert not torch.equal(params["w"], before["0"]["w"])
    ck.wait()
    restored, step, _ = ck.restore([params, opt])
    assert step == 1
    for k in ("w", "b"):
        assert torch.equal(restored["0"][k], before["0"][k])
        assert torch.equal(restored["1"]["m"][k], before["1"]["m"][k])
    assert int(restored["1"]["step"]) == 1


def test_checkpoint_writes_the_reference_layout(tmp_path):
    """A [params, opt_state] save reads back through the reference's
    checkpoint reader as the tuple it saves: leaf paths "0/...", "1/..."."""
    from repro.checkpoint import Checkpointer as JCheckpointer
    params = {"a": {"w": torch.arange(6.0).reshape(2, 3)}}
    opt = adamw_init(params)
    Checkpointer(tmp_path).save(3, [params, opt], extra={"data_step": 3})
    tree = load_reference_checkpoint(tmp_path / "step_00000003")
    assert set(tree) == {"0", "1"} and set(tree["1"]) == {"m", "v", "step"}
    j, step, extra = JCheckpointer(tmp_path).restore(
        ({"a": {"w": np.zeros((2, 3), np.float32)}},
         {"m": {"a": {"w": np.zeros((2, 3), np.float32)}},
          "v": {"a": {"w": np.zeros((2, 3), np.float32)}},
          "step": np.zeros((), np.int32)}))
    assert step == 3 and extra == {"data_step": 3}
    np.testing.assert_array_equal(j[0]["a"]["w"], params["a"]["w"].numpy())


# ------------------------------------------------------------------ optim
def test_adamw_first_step_is_lr_sized():
    """After bias correction, |Δp| of step 1 ~= lr (Adam property)."""
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.0, grad_clip=1e9)
    p = {"w": torch.ones(4) * 2.0}
    g = {"w": torch.tensor([0.5, -0.5, 2.0, -2.0])}
    s = adamw_init(p)
    w0 = p["w"].clone()
    p2, s2, m = adamw_update(p, g, s, cfg)
    step = (p2["w"] - w0).abs().numpy()
    np.testing.assert_allclose(step, cfg.lr, rtol=1e-3)
    assert int(s2["step"]) == 1


def test_adamw_grad_clipping():
    cfg = AdamWConfig(lr=1e-2, grad_clip=1.0, weight_decay=0.0)
    p = {"w": torch.zeros(3)}
    g = {"w": torch.tensor([300.0, 400.0, 0.0])}     # norm 500
    _, _, m = adamw_update(p, g, adamw_init(p), cfg)
    assert float(m["grad_norm"]) == pytest.approx(500.0)


def test_cosine_schedule_shape():
    assert float(cosine_schedule(torch.tensor(0), warmup=10,
                                 total=100)) == 0.0
    assert float(cosine_schedule(torch.tensor(10), warmup=10,
                                 total=100)) == pytest.approx(1.0)
    end = float(cosine_schedule(torch.tensor(100), warmup=10, total=100))
    assert end == pytest.approx(0.1, abs=1e-3)


# ------------------------------------------------------------------ compress
def test_quantize_roundtrip_bounded_error():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    q, s = quantize_int8(x)
    assert q.dtype == torch.int8
    err = (dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_error_feedback_unbiased_over_steps():
    """With error feedback, the CUMULATIVE compressed gradient converges to
    the cumulative true gradient (bias -> 0)."""
    rng = np.random.default_rng(1)
    g_true = {"w": torch.from_numpy(rng.standard_normal(64).astype(
        np.float32))}
    err = None
    acc = torch.zeros(64)
    for t in range(50):
        dq, err = compress_grads(g_true, err)
        acc += dq["w"]
    np.testing.assert_allclose((acc / 50).numpy(), g_true["w"].numpy(),
                               atol=1e-2)


# ------------------------------------------------------------------ elastic
def test_elastic_rebalance_covers_all_shards():
    pl = ElasticPlanner(n_logical_shards=256)
    for pods in ([0, 1], [0, 1, 2], [1, 3, 5, 7]):
        asg = pl.assign(pods)
        covered = sorted((a.lo, a.hi) for a in asg)
        assert covered[0][0] == 0 and covered[-1][1] == 256
        for (l1, h1), (l2, h2) in zip(covered, covered[1:]):
            assert h1 == l2
    plan = pl.on_membership_change([0, 1, 2], [0, 2])
    assert plan["lost"] == [1] and plan["mesh_pods"] == 2


def test_straggler_monitor_flags_slow_host():
    m = StragglerMonitor(threshold=1.5, patience=3)
    for step in range(10):
        for h in range(4):
            m.report(h, 1.0 if h != 2 else 3.0)
        ev = m.evictions()
    assert ev == [2]


# ------------------------------------------------------------------ e2e
def test_train_driver_loss_decreases(tmp_path):
    from repro_torch.launch.train import train
    _, losses = train("qwen1.5-4b", smoke=True, steps=12, global_batch=2,
                      seq_len=64, ckpt_dir=str(tmp_path), ckpt_every=6,
                      log_every=0, device="cpu")
    assert losses[-1] < losses[0]
    ck = Checkpointer(tmp_path)
    assert 12 in ck.steps()


def test_train_driver_restart_continues(tmp_path):
    from repro_torch.launch.train import train
    train("qwen1.5-4b", smoke=True, steps=6, global_batch=2, seq_len=64,
          ckpt_dir=str(tmp_path), ckpt_every=3, log_every=0, device="cpu")
    _, losses = train("qwen1.5-4b", smoke=True, steps=9, global_batch=2,
                      seq_len=64, ckpt_dir=str(tmp_path), ckpt_every=3,
                      restore=True, log_every=0, device="cpu")
    assert len(losses) == 3               # resumed at 6, ran 6..9


def test_train_driver_restart_equals_straight_run(tmp_path):
    """A 6-step run whose host died after step 4's checkpoint (its step-6
    checkpoint removed), restored, gives the last two losses and the
    final parameters of the run that did not stop, bit for bit: the data
    pipeline resumes at its step and AdamW at its own."""
    import shutil
    from repro_torch.launch.train import train
    kw = dict(smoke=True, steps=6, global_batch=2, seq_len=16, log_every=0,
              ckpt_every=2, device="cpu")
    straight, losses = train("qwen1.5-4b", ckpt_dir=str(tmp_path), **kw)
    assert Checkpointer(tmp_path).steps() == [2, 4, 6]
    shutil.rmtree(tmp_path / "step_00000006")
    resumed, tail = train("qwen1.5-4b", ckpt_dir=str(tmp_path),
                          restore=True, **kw)
    assert tail == losses[4:]
    for (path, a), (_, b) in zip(flatten(straight), flatten(resumed)):
        assert torch.equal(a, b), path


def test_train_driver_with_grad_compress_trains():
    from repro_torch.launch.train import train
    _, losses = train("qwen3-8b", smoke=True, steps=6, global_batch=2,
                      seq_len=16, grad_compress=True, lr=3e-3, log_every=0,
                      device="cpu")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_train_driver_without_device_needs_cuda(monkeypatch):
    from repro_torch.launch.train import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train("qwen1.5-4b", steps=1, global_batch=2, seq_len=16)

