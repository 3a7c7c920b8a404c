"""One run of a training cell on one rank: set-up, the first steps that
the check compares, the measured window, the traced steps, the plain
reference and the comparison.

The timed entry is the program's own: `launch.train.make_train_step` on
batches from `launch.train.batch_on`, and on a joined mesh
(`launch.mesh.join_host_mesh`) the same step with `mesh=`. The program
receives the weights the benchmark drew (`harness.weights`) in its own
parameter tree and the batches of the cell's traffic; it builds its AdamW
state (`optim.adamw_init`) itself. Set-up runs the first steps through
that same step object on steps 0, 1, ... of the traffic, reads from the
program's state what the check compares (`harness.compare`), runs one
more step, and hands the object to the window, which goes on from the
step after it.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import pathlib
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"

THREADS = 4         # the host's intra-op threads: load from few threads
TRACE_STEPS = 3     # steps profiled after the window with --trace 1


def process_env():
    """The environment of a run, set before torch is imported: every build
    and kernel cache inside the checkout, at fixed paths; transformers kept
    from loading JAX."""
    cache = ROOT / "build" / "perfbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("USE_FLAX", "0")


def load_module(path: pathlib.Path):
    """A module of the benchmark's data-driven parts, by its file."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(name: str, root: pathlib.Path = ROOT) -> dict:
    """The cell `name` of BENCHMARK.json, with its configuration, traffic,
    workload file and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    base = root / "perfbench"
    spec = {
        "name": name, "cell": cell,
        "config": json.loads((base / "configs" /
                              f"{cell['config']}.json").read_text()),
        "traffic": json.loads((base / "traffic" /
                               f"{cell['traffic']}.json").read_text()),
        "workload": json.loads((base / "workloads" /
                                f"{name}.json").read_text()),
    }
    spec["end_to_end"] = [m for m in bench["end_to_end"]
                          if name in m.get("workloads", [name])]
    moved = {m["name"] for m in spec["end_to_end"]}
    spec["per_layer"] = [m for m in bench["per_layer"]
                         if (name in m["workloads"] if "workloads" in m
                             else m["moves"] in moved)]
    return spec


# fields of the program's ModelConfig a configuration file sets
CONFIG_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                 "d_ff", "vocab_size", "qkv_bias", "rope_theta",
                 "tie_embeddings", "norm", "act", "param_dtype",
                 "compute_dtype", "opt_moment_dtype")
SSM_FIELDS = ("d_state", "d_conv", "expand", "dt_rank")
MOE_FIELDS = ("n_experts", "top_k", "capacity_factor", "d_ff_expert",
              "aux_loss", "router_z_loss")


def program_config(config: dict):
    """The program's ModelConfig for a configuration file: the program's
    configuration of that architecture (its family's quirks) with every
    size the file states, and the sizes it derives checked against the
    file's."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import LayerSpec
    cfg = registry.get_config(config["program_arch"])
    kw = {k: config[k] for k in CONFIG_FIELDS}
    kw.update(use_rope=config["rope"], block_pattern=tuple(
        LayerSpec(**s) for s in config["layers"]))
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, **{k: config[k] for k in SSM_FIELDS})
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, **{k: config[k] for k in MOE_FIELDS})
    cfg = dataclasses.replace(cfg, **kw)
    if cfg.hd != config["head_dim"] or (
            cfg.ssm is not None and (cfg.d_inner, cfg.dt_rank)
            != (config["d_inner"], config["dt_rank"])):
        raise ValueError(f"{config['name']}: the program derives other "
                         "widths than the file states")
    return cfg


@dataclasses.dataclass
class Rank:
    """Where this process runs: its device and, across cards, its joined
    mesh, its gloo group for the window's stop flag, and its experts."""
    device: str
    mesh: object = None
    flag_group: object = None
    first_expert: int = 0

    @property
    def ranks(self):
        """The reference's (group, first expert held), or None."""
        if self.mesh is None:
            return None
        return (self.mesh.group, self.first_expert)


def held_leaves(meta, mesh):
    """The leaves this rank holds, from the program's tree on `meta`:
    ({path: shape}, {expert leaf: (first expert, count)}, [expert
    leaves]); across a mesh each rank holds E / tp experts of each expert
    leaf, from tp_rank * E / tp."""
    from perfbench.harness import weights
    from repro_torch.tree import flatten
    shapes, experts, split = {}, {}, []
    for path, t in flatten(meta):
        shape = tuple(t.shape)
        if mesh is not None and path.rsplit("/", 1)[-1] in \
                weights.EXPERT_LEAVES:
            held = shape[1] // mesh.tp_size
            experts[path] = (mesh.tp_rank * held, held)
            shape = (shape[0], held, *shape[2:])
            split.append(path)
        shapes[path] = shape
    return shapes, experts, split


def _sync(device):
    import torch
    if device.startswith("cuda"):
        torch.cuda.synchronize(device)


def run(spec, seed: int, seconds: float, trace: bool, started: float,
        rank: Rank, faults=()) -> dict:
    """One rank's run. `started`: the process's start, host wall clock.
    `faults`: names of planted faults (`harness.faults`), for the tests.
    Returns the rank's readings (rank 0: all of them)."""
    import torch
    from repro_torch.launch import train as ptrain
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import flatten, unflatten

    from perfbench.harness import compare, faults as planted, weights
    from perfbench.harness.trace import traced
    from perfbench.reference import train as ref_train

    config, traffic, work = spec["config"], spec["traffic"], spec["workload"]
    gen = load_module(BENCH / "generators" / f"{traffic['generator']}.py")
    opt = traffic["optimizer"]
    cfg = program_config(config)
    dev = rank.device
    mesh = rank.mesh
    parts = {"imports": time.time() - started}

    # the weights, in the program's tree, this rank's experts
    meta = lm.init_params(None, cfg, device="meta")
    shapes, experts, split = held_leaves(meta, mesh)
    rank.first_expert = min((e[0] for e in experts.values()), default=0)

    def make_leaf(path):
        return weights.draw(path, shapes[path], seed, dev,
                            experts.get(path))

    params = unflatten(meta, {p: make_leaf(p).to(cfg.pdtype)
                              for p in shapes})
    opt_state = adamw_init(params, getattr(torch, cfg.opt_moment_dtype))
    _sync(dev)
    parts["weights"] = time.time() - started
    step_fn = ptrain.make_train_step(
        cfg, AdamWConfig(**{k: opt[k] for k in (
            "lr", "b1", "b2", "eps", "weight_decay", "grad_clip")}),
        opt["total_steps"], mesh=mesh)
    step_fn = planted.wrap(step_fn, faults)
    V = config["vocab_size"]
    ranks = rank.ranks

    def feed(s):
        return ptrain.batch_on(gen.batch(traffic, V, seed, s), cfg, dev)

    # the first steps, through the window's own step and feed
    n_first = work["reference_steps"]
    prog = {"losses": []}
    for s in range(n_first):
        params, opt_state, _, met = step_fn(params, opt_state, 0, feed(s))
        prog["losses"].append(float(met["loss"]))
        if s == 0:
            prog["grad_norm"] = float(met["grad_norm"])
            moment = ref_train.slice_norms(dict(flatten(opt_state["m"])),
                                           ranks, split)
            prog["grad_slices"] = {k: v / (1 - opt["b1"])
                                   for k, v in moment.items()}
    _sync(dev)
    parts["first_steps"] = time.time() - started
    prog["change_slices"] = ref_train.change_norms(
        dict(flatten(params)), make_leaf, ranks, split)
    parts["check_read"] = time.time() - started
    # that read drew leaves as large as the program's largest: give their
    # memory back and run one more step, so that the window starts from the
    # program's own allocator state (a cached block split by the draws left
    # falcon's 8 GiB gradient squares without room), and count the peak
    # from that step on: the program's, not the check's draws
    if dev.startswith("cuda"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    params, opt_state, _, met = step_fn(params, opt_state, 0, feed(n_first))
    float(met["loss"])
    _sync(dev)
    setup_s = time.time() - started
    parts["warm_step"] = setup_s

    # the window
    step = n_first + 1
    times, losses = [], []

    def one_step():
        nonlocal params, opt_state, step
        batch = feed(step)
        t0 = time.perf_counter()
        params, opt_state, _, m = step_fn(params, opt_state, 0, batch)
        losses.append(float(m["loss"]))
        t1 = time.perf_counter()
        times.append(t1 - t0)
        step += 1
        return t1

    t_win = time.perf_counter()
    while True:
        end = one_step()
        if _stop(end - t_win >= seconds, rank):
            break
    window_s = end - t_win
    n_window = len(times)
    out = {"setup_s": setup_s, "setup_parts": parts, "window_s": window_s,
           "steps": n_window, "step_s": list(times), "losses": list(losses),
           "trace": None}

    if trace:
        def run_steps(k):
            for _ in range(k):
                one_step()
        out["trace"] = traced(run_steps, TRACE_STEPS,
                              cpu=not dev.startswith("cuda"))

    cuda = dev.startswith("cuda")
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if cuda else 0)
    out["kind"] = torch.cuda.get_device_name(dev) if cuda else "cpu"
    del params, opt_state, step_fn, met
    gc.collect()
    if dev.startswith("cuda"):
        torch.cuda.empty_cache()

    # the plain reference, from the same weights and batches
    batches = []
    for s in range(n_first):
        b = gen.batch(traffic, V, seed, s)
        batches.append((torch.as_tensor(b["tokens"], device=dev),
                        torch.as_tensor(b["loss_mask"], device=dev)))
    t0 = time.perf_counter()
    ref = ref_train.follow(config, opt, make_leaf, list(shapes), batches,
                           ranks=ranks, split=split)
    out["reference_s"] = time.perf_counter() - t0
    read = compare.readings(prog, ref)
    limits = work["limits"]
    out["readings"] = read
    out["limits"] = limits
    out["correct"] = compare.verdict(read, limits) and all(
        math.isfinite(x) for x in losses)
    out["failed"] = sum(1 for x in losses if not math.isfinite(x))
    return out


def _stop(mine: bool, rank: Rank) -> bool:
    """Whether the window ends after this step: rank 0's clock decides for
    every rank (a host-side gloo broadcast, no device work)."""
    if rank.flag_group is None:
        return mine
    import torch
    import torch.distributed as dist
    flag = torch.tensor([1 if mine else 0], dtype=torch.int32)
    dist.broadcast(flag, src=0, group=rank.flag_group)
    return bool(flag.item())
