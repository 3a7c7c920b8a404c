"""The port's jax-free checkpoint reader against the reference's
`Checkpointer`, on the trained step-18 JOB agent."""
import hashlib
import json
import pathlib
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import Checkpointer, agent_state  # noqa: E402
from repro.checkpoint.checkpointer import _flatten  # noqa: E402
from repro.core.agent import AgentConfig as JAgentConfig  # noqa: E402
from repro.core.agent import AqoraAgent as JAgent  # noqa: E402
from repro.core.encoding import WorkloadMeta as JMeta  # noqa: E402
from repro_torch.checkpoint import (load_reference_checkpoint,  # noqa: E402
                                    params_from_numpy)
from repro_torch.core.agent import AgentConfig, AqoraAgent  # noqa: E402
from repro_torch.core.encoding import WorkloadMeta  # noqa: E402

CKPT_DIR = pathlib.Path(__file__).resolve().parents[1] / "results" / \
    "aqora_ckpt"
STEP = CKPT_DIR / "step_00000018"
TABLES = {f"t{i}": i for i in range(20)}        # feat_dim 26, as JOB's


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_leaves_bit_equal_to_reference_restore():
    ref_agent = JAgent(JMeta(TABLES, 17), JAgentConfig(), seed=0)
    tree, step, _ = Checkpointer(CKPT_DIR).restore(agent_state(ref_agent),
                                                   step=18)
    assert step == 18
    ref = dict(_flatten(tree))
    port = _flat(load_reference_checkpoint(STEP))
    assert set(port) == set(ref)
    for name, arr in ref.items():
        assert port[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(port[name], arr, err_msg=name)

    agent = AqoraAgent(WorkloadMeta(TABLES, 17), AgentConfig(), seed=0,
                       device="cpu")
    agent.load_params(params_from_numpy(load_reference_checkpoint(STEP)))
    assert agent.param_count() == 161549
    for net in ("actor", "critic"):
        for name, p in getattr(agent, net).state_dict().items():
            ref_leaf = ref[f"{net}/" + name.replace(".", "/")]
            np.testing.assert_array_equal(p.numpy(), ref_leaf)


@pytest.mark.parametrize("corrupt", ["manifest_sha1", "leaf_bytes"])
def test_corrupted_checkpoint_raises(tmp_path, corrupt):
    d = tmp_path / "step"
    shutil.copytree(STEP, d)
    if corrupt == "manifest_sha1":
        manifest = json.loads((d / "MANIFEST.json").read_text())
        manifest["arrays"]["actor/enc/conv2/wl"]["sha1"] = "0" * 40
        (d / "MANIFEST.json").write_text(json.dumps(manifest))
    else:
        arr = np.load(d / "critic__head__w2.npy")
        arr[0, 0] += 1.0
        np.save(d / "critic__head__w2.npy", arr)
    with pytest.raises(IOError, match="checksum"):
        load_reference_checkpoint(d)


def _bf16_tree():
    """A tree with a bf16 leaf (seeded words, one NaN's and one
    subnormal's among them), an fp32 and an int32 leaf: the port's
    tensors and the same bits as the reference's jax arrays."""
    import jax.numpy as jnp
    import ml_dtypes
    words = np.random.default_rng(4).integers(
        0, 1 << 16, (3, 7), dtype=np.uint16)
    words[0, :2] = (0x7FC1, 0x0003)
    w = np.random.default_rng(5).standard_normal((2, 5)).astype(np.float32)
    port = {"a": {"w": torch.from_numpy(words.view(np.int16)).view(
        torch.bfloat16), "f": torch.from_numpy(w)},
        "step": torch.tensor(7, dtype=torch.int32)}
    ref = {"a": {"w": jnp.asarray(words.view(ml_dtypes.bfloat16)),
                 "f": jnp.asarray(w)}, "step": jnp.asarray(7, jnp.int32)}
    return port, ref, words


def test_bf16_leaf_is_written_as_the_reference_writes_it(tmp_path):
    """A bf16 tensor saved by the port: the reference's file bytes (a
    `<V2` header, the bf16 words) and its manifest entry (dtype
    "bfloat16", the sha1 of the words)."""
    port, ref, words = _bf16_tree()
    from repro_torch.checkpoint import Checkpointer as TCheckpointer
    TCheckpointer(tmp_path / "port").save(1, port, extra={"k": 1})
    Checkpointer(tmp_path / "ref").save(1, ref, extra={"k": 1})
    got, want = (tmp_path / d / "step_00000001" for d in ("port", "ref"))
    names = sorted(p.name for p in want.iterdir())
    assert names == sorted(p.name for p in got.iterdir())
    for name in names:
        if name != "MANIFEST.json":
            assert (got / name).read_bytes() == (want / name).read_bytes()
    arrays = json.loads((got / "MANIFEST.json").read_text())["arrays"]
    assert arrays == json.loads((want / "MANIFEST.json").read_text())[
        "arrays"]
    assert arrays["a/w"]["dtype"] == "bfloat16"
    assert arrays["a/w"]["sha1"] == hashlib.sha1(words.tobytes()).hexdigest()


def test_reference_bf16_checkpoint_restores_bit_for_bit(tmp_path):
    """A checkpoint the reference wrote with a bf16 leaf (its reader gives
    it back as `|V2` words) restores in the port as bf16, bit for bit,
    also into a live tree's tensors; the jax-free reader gives the same
    `|V2` words as the reference's."""
    port, ref, words = _bf16_tree()
    from repro_torch.checkpoint import Checkpointer as TCheckpointer
    Checkpointer(tmp_path).save(3, ref)
    read = load_reference_checkpoint(tmp_path / "step_00000003")
    jtree, _, _ = Checkpointer(tmp_path).restore(ref)
    assert read["a"]["w"].dtype.str == jtree["a"]["w"].dtype.str == "|V2"
    np.testing.assert_array_equal(read["a"]["w"].view(np.uint16), words)
    tree, step, _ = TCheckpointer(tmp_path).restore(port)
    assert step == 3 and tree["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tree["a"]["w"].view(torch.int16).numpy().view(np.uint16), words)
    live = {"a": {"w": torch.zeros((3, 7), dtype=torch.bfloat16),
                  "f": torch.zeros(2, 5)},
            "step": torch.tensor(0, dtype=torch.int32)}
    into, _, _ = TCheckpointer(tmp_path).restore(live, into=True)
    assert into is live and int(live["step"]) == 7
    assert torch.equal(live["a"]["w"].view(torch.int16),
                       port["a"]["w"].view(torch.int16))
    assert torch.equal(live["a"]["f"], port["a"]["f"])
