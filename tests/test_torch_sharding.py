"""The port's sharding rules and activation policy against the JAX
package's, on the CPU.

* `param_specs` (parameters and AdamW state) for all ten architectures
  at their published sizes, on the 16x16 and 2x16x16 production meshes
  (`MeshAxes` built from sizes): the port's specs, over its `meta`
  parameters, equal the reference's, over `jax.eval_shape`'s, leaf for
  leaf as tuples;
* `batch_specs` and `cache_specs` (both `kv_seq` settings) for every
  `registry.assigned_cells()` entry;
* `act.spec_for` against the spec the reference's `constrain` hands to
  `jax.lax.with_sharding_constraint` (captured), and `act.constrain`
  returning its input itself, with and without a policy.

Exact: the rules are shape logic.
"""
import functools

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.sharding import act as jact  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.sharding import act, rules  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

MESHES = {"16x16": (("data", 16), ("model", 16)),
          "2x16x16": (("pod", 2), ("data", 16), ("model", 16))}


def axes_pair(mesh):
    sizes = MESHES[mesh]
    pod = "pod" if mesh == "2x16x16" else None
    return (jrules.MeshAxes(pod=pod, sizes=sizes),
            rules.MeshAxes(pod=pod, sizes=sizes))


def ref_leaves(specs):
    """(path, spec as a tuple) of a reference spec tree, keys sorted."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    out = [("/".join(str(k.key) for k in kp), tuple(s)) for kp, s in flat]
    return sorted(out)


def port_leaves(specs):
    return sorted((path, tuple(s)) for path, s in flatten(specs))


@functools.lru_cache(maxsize=None)
def ref_structs(arch):
    cfg = jregistry.get_config(arch)
    return jsteps.params_struct(cfg), jsteps.opt_struct(cfg)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", jregistry.ARCHS)
def test_param_specs_match_reference(arch, mesh):
    jaxes, taxes = axes_pair(mesh)
    jp, jo = ref_structs(arch)
    cfg = registry.get_config(arch)
    for want, got in ((jrules.param_specs(jp, jaxes),
                       rules.param_specs(steps.params_struct(cfg), taxes)),
                      (jrules.param_specs(jo, jaxes),
                       rules.param_specs(steps.opt_struct(cfg), taxes))):
        assert port_leaves(got) == ref_leaves(want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_cache_specs_match_reference(mesh):
    """Every assigned cell: the batch's specs, and for decode cells the
    cache's with kv_seq off and on."""
    jaxes, taxes = axes_pair(mesh)
    for arch, shape, ok, _ in registry.assigned_cells():
        jcfg, tcfg = jregistry.get_config(arch), registry.get_config(arch)
        jshape, tshape = JSHAPES[shape], SHAPES[shape]
        assert port_leaves(rules.batch_specs(
            steps.batch_struct(tcfg, tshape), taxes)) == ref_leaves(
            jrules.batch_specs(jsteps.batch_struct(jcfg, jshape), jaxes))
        if tshape.kind != "decode":
            continue
        jc = jsteps.cache_struct(jcfg, jshape)
        tc = steps.cache_struct(tcfg, tshape)
        for kv_seq in (False, True):
            assert port_leaves(rules.cache_specs(tc, taxes, kv_seq)) == \
                ref_leaves(jrules.cache_specs(jc, jaxes, kv_seq)), \
                (arch, shape, kv_seq)


def test_mesh_axes_from_production_meshes():
    for multi, mesh in ((False, "16x16"), (True, "2x16x16")):
        m = make_production_mesh(multi_pod=multi)
        _, taxes = axes_pair(mesh)
        assert rules.MeshAxes.from_mesh(m) == taxes
        assert m.name() == mesh and m.size == (512 if multi else 256)
    host = make_host_mesh()
    assert host.axis_names == ("data", "model") and host.shape[0] == 1


ROLE_CASES = [((256, 4096, 32, 128), {0: "dp", 1: "tp"}),
              ((256, 4096, 32, 128), {0: "dp", 2: "tp"}),
              ((1, 524288, 8, 128), {0: "dp", 1: "tp"}),
              ((48, 6, 7), {0: "dp", 1: "tp", 2: "tp"}),
              ((16, 1, 16), {0: "dp", 1: "tp"}),
              ((3, 5), {0: "dp"})]
POLICIES = [dict(dp_axes=("data",), dp_size=16, tp_size=16),
            dict(dp_axes=("pod", "data"), dp_size=32, tp_size=16),
            dict(dp_axes=("data",), dp_size=1, tp_size=1)]


@pytest.mark.parametrize("pol", range(len(POLICIES)))
def test_spec_for_matches_reference_constrain(pol, monkeypatch):
    """spec_for gives the spec the reference's constrain applies (None
    where it applies none); the port's constrain returns x itself."""
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    for shape, roles in ROLE_CASES:
        x = jnp.zeros(shape, jnp.int8)
        t = torch.zeros(shape, dtype=torch.int8, device="meta")
        seen.clear()
        with jact.policy(jact.ActivationPolicy(**POLICIES[pol])):
            jact.constrain(x, roles)
        with act.policy(act.ActivationPolicy(**POLICIES[pol])):
            got = act.spec_for(shape, roles)
            assert act.constrain(t, roles) is t
        assert (None if got is None else tuple(got)) == \
            (seen[0] if seen else None), (shape, roles)
    seen.clear()
    assert jact.constrain(jnp.zeros((16, 16)), {0: "dp"}) is not None
    assert not seen and act.spec_for((16, 16), {0: "dp"}) is None


def test_policy_is_thread_local_and_nests():
    import threading
    outer = act.ActivationPolicy(remat="dots")
    inner = act.ActivationPolicy(remat="none")
    with act.policy(outer):
        with act.policy(inner):
            assert act.current() is inner
        assert act.current() is outer
        other = []
        th = threading.Thread(target=lambda: other.append(act.current()))
        th.start()
        th.join()
        assert other == [None]
    assert act.current() is None
