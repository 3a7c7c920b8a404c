"""The port's jax-free checkpoint reader against the reference's
`Checkpointer`, on the trained step-18 JOB agent."""
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
