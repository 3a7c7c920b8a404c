"""Dry run of one (arch x shape) cell on one NVIDIA H100, with no card:
the port's counterpart of the reference's `repro.launch.dryrun`.

The reference lowers and compiles each cell on 512 placeholder host
devices and reads memory, FLOPs, bytes and collectives from the compiled
program under a TPU roofline. The port runs the cell's step function
(`launch.steps`) once on tensors on the `meta` device, which hold shapes
and no data, under the layout's sharding policy and under the op counter
(`launch.opanalysis`), and reads the result under the H100 roofline
(`launch.roofline`):

  * it runs (the model code, the kernels' wrappers, autograd and the
    optimizer take every step they take on the card);
  * its FLOPs and bytes, op by op, the kernels' own records included;
  * its arguments', outputs' and peak live bytes on the one card, and
    whether they fit the card's 80 GB (`fits`).

It sets no XLA flag and needs no GPU. `chips` is 1; `mesh` names the
production layout the policy plans for (16x16, or 2x16x16 multi-pod),
whose sharding constraints are no-ops on one card.

`count_serve` counts a `BatchedServer`'s program the same way: the
seeded serving build and a `generate`'s prefill and decode steps, on
`meta`; with a joined mesh, the program of one rank (its own experts,
the all_reduce moving no data on `meta`), whose `peak_live_bytes` the
card's `max_memory_allocated` is held to (chip_smoke.py's shard phase).
`count_train` counts one rank's train step across a mesh the same way:
the rank's seeded build (its E/tp experts), its AdamW state and one step
of `steps.make_train_step(..., mesh=)`; a descriptor mesh with a rank
counts that rank's program as if joined (on `meta` no collective runs).

Results go to results/dryrun_h100/<arch>__<shape>.json, one file a
cell, so that a sweep can be resumed. Counting costs host time a
dispatched op: a cell whose step runs the scan's plain backward (the
train_4k cells of falcon-mamba-7b and jamba, a Python loop over 4096
steps a layer) takes long.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--force]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import opanalysis
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import MeshAxes
from repro_torch.sharding import act as act_sharding

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" \
    / "dryrun_h100"
CARD_BYTES = 80e9          # the H100's 80 GB of HBM3


def _useful_params(cfg) -> int:
    """Active params for the 6ND/2ND model; untied embed tables do no matmul."""
    n = cfg.active_param_count()
    if not cfg.tie_embeddings and cfg.family != "audio":
        n -= cfg.vocab_size * cfg.d_model
    return n


def layout_policy(mesh, layout=None) -> act_sharding.ActivationPolicy:
    """The activation policy a layout gives on `mesh`, as the reference
    builds it."""
    axes = MeshAxes.from_mesh(mesh)
    return act_sharding.ActivationPolicy(
        dp_axes=axes.dp_axes, tp_axis=axes.model,
        dp_size=axes.dp_size, tp_size=axes.size(axes.model),
        attn_mode=layout.attn_mode if layout else "seq",
        ce_chunk=layout.ce_chunk if layout else None,
        remat=layout.remat if layout else "full",
        attn_remat=layout.attn_remat if layout else False,
        mla_absorb=layout.mla_absorb if layout else False,
        attn_scores_bf16=layout.attn_scores_bf16 if layout else False,
        moe_dispatch=layout.moe_dispatch if layout else "global",
        mesh=mesh)


def _storages(tree):
    return {t.untyped_storage(): t.untyped_storage().nbytes()
            for t in opanalysis.tensors(tree)}


def count_step(cfg, shape, layout=None, *, multi_pod=False, inputs=None):
    """Run the cell's step once under the layout's policy and an
    `OpCounter`. Returns (counter, {"argument", "output", "alias"} bytes,
    seconds). `inputs` (the step's positional inputs, on any device)
    default to `steps.input_specs` on `meta`."""
    if shape.kind == "train" and layout is not None and layout.grad_compress:
        fn = steps_mod.make_train_step(cfg, grad_compress=True)
    else:
        fn = steps_mod.step_fn(cfg, shape)
    if inputs is None:
        inputs = steps_mod.input_specs(cfg, shape)
    pol = layout_policy(make_production_mesh(multi_pod=multi_pod), layout)
    t0 = time.perf_counter()
    with act_sharding.policy(pol), opanalysis.OpCounter() as counter:
        args = counter.track(inputs)
        out = fn(*inputs)
    seconds = time.perf_counter() - t0
    ins, outs = _storages(inputs), _storages(out)
    alias = sum(n for st, n in outs.items() if st in ins)
    return counter, {"argument": args, "output": sum(outs.values()),
                     "alias": alias}, seconds


def count_serve(cfg, requests: int, prompt_len: int, gen: int, *,
                mesh=None, steps: int = 2):
    """A `BatchedServer(cfg, seed=..., mesh=mesh)` build and the prefill
    and first `steps` decode steps of its `generate(prompts, gen)`, run
    on `meta` under an `OpCounter` (later steps repeat the first: the
    cache is allocated whole at the prefill). Returns the counter."""
    import torch
    from repro_torch.models import lm
    B, P = requests, prompt_len
    pol = None if mesh is None else act_sharding.ActivationPolicy(
        moe_dispatch="shard_map", mesh=mesh)
    with opanalysis.OpCounter() as counter:
        params = lm.init_params(None, cfg, device="meta", serving=True,
                                mesh=mesh)
        tokens = torch.zeros((B, P), dtype=torch.int64, device="meta")
        out = torch.zeros((B, gen), dtype=torch.int64, device="meta")
        counter.track(tokens, out)
        memory = None
        if cfg.family == "vlm":
            memory = torch.zeros((B, cfg.vision_tokens, cfg.d_model),
                                 dtype=cfg.cdtype, device="meta")
        with act_sharding.policy(pol), torch.inference_mode():
            if cfg.encoder is not None:
                memory = lm.encode(params, torch.zeros(
                    (B, cfg.encoder.n_frames, cfg.d_model), device="meta"),
                    cfg)
            logits, cache = lm.prefill(params, tokens, cfg, max_len=P + gen,
                                       memory=memory)
            tok = logits.argmax(-1)[:, None]
            for t in range(min(steps, gen)):
                logits, cache = lm.decode_step(params, tok, cache, cfg, P + t)
                tok = logits.argmax(-1)[:, None]
    return counter


def count_train(cfg, batch: int, seq: int, *, mesh=None):
    """One train step of `steps.make_train_step(cfg, mesh=mesh)` on
    (batch, seq) tokens (with the family's memory or frames,
    `steps.batch_struct`) from the rank's seeded build
    (`lm.init_params(..., mesh=)`, fp32 as cfg keeps it) and its AdamW
    state, run on `meta` under an `OpCounter`. Returns the counter."""
    import torch
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    if mesh is not None and not act_sharding.joined(mesh):
        mesh = dataclasses.replace(mesh, group="meta")
    step = steps_mod.make_train_step(cfg, mesh=mesh)
    with opanalysis.OpCounter() as counter:
        params = lm.init_params(None, cfg, device="meta", mesh=mesh)
        opt = adamw_init(params, getattr(torch, cfg.opt_moment_dtype))
        inputs = steps_mod.batch_struct(
            cfg, ShapeConfig("train", seq, batch, "train"))
        counter.track(inputs)
        step(params, opt, inputs)
    return counter


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             verbose=True, layout=None, *, cfg=None, shape=None) -> dict:
    """layout: optional `adapt.knobs.LayoutPlan` overriding the default
    activation layout (the re-optimizer re-counts cells through here).
    cfg/shape: a cut configuration or shape in place of the registry's."""
    cfg = cfg or registry.get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    counter, mem, seconds = count_step(cfg, shape, layout,
                                       multi_pod=multi_pod)
    peak = counter.peak_live_bytes
    n_use = _useful_params(cfg)
    roof = rl.Roofline(
        flops_per_device=counter.flops, bytes_per_device=counter.bytes,
        coll_bytes_per_device=0.0, chips=1,
        model_flops=rl.model_flops(cfg, shape, n_use))
    mem_d = {"argument_size_in_bytes": mem["argument"],
             "output_size_in_bytes": mem["output"],
             "alias_size_in_bytes": mem["alias"],
             # the most the step held beyond its arguments
             "temp_size_in_bytes": peak - mem["argument"],
             "generated_code_size_in_bytes": 0,
             "live_bytes_per_device": peak}
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh.name(), "chips": 1,
        "hardware": "one NVIDIA H100 SXM at its data-sheet peaks "
                    "(launch.roofline), counted on meta",
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "n_layers": cfg.n_layers, "global_batch": shape.global_batch,
        "seq_len": shape.seq_len, "t_count_s": seconds,
        "memory": mem_d,
        "hlo_analysis": {"flops": counter.flops, "bytes": counter.bytes,
                         "ops": counter.ops,
                         "note": "counted op by op (launch.opanalysis)"},
        "kernels": counter.kernel_totals(),
        "collectives": {"total": 0.0}, "roofline": roof.to_dict(),
        "fits": peak <= CARD_BYTES, "card_bytes": CARD_BYTES,
        "ok": True,
    }
    if verbose:
        print(f"== {arch} x {shape_name} on one H100 (plans {rec['mesh']}) ==")
        print(f"memory: {mem_d} fits={rec['fits']}")
        print(f"counted: flops={counter.flops:.3e} bytes={counter.bytes:.3e} "
              f"ops={counter.ops}")
        print(f"roofline: compute={roof.t_compute:.4f}s "
              f"memory={roof.t_memory:.4f}s -> {roof.bottleneck}-bound, "
              f"useful={roof.useful_flops_ratio:.3f} "
              f"mfu_bound={roof.mfu_bound:.3f}")
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true", help="recompute existing cells")
    args = ap.parse_args()

    if args.all:
        cells = registry.assigned_cells()
    else:
        cells = [(args.arch, args.shape, True, "")]
    RESULTS.mkdir(parents=True, exist_ok=True)
    n_fail = 0
    for arch, shape, ok, why in cells:
        out = RESULTS / f"{arch}__{shape}.json"
        if out.exists() and not args.force:
            prev = json.loads(out.read_text())
            if prev.get("ok"):
                print(f"skip (cached): {out.name}")
                continue
        if not ok:
            out.write_text(json.dumps(
                {"arch": arch, "shape": shape, "ok": True,
                 "skipped": True, "reason": why}, indent=1))
            print(f"skip (n/a): {arch} x {shape}: {why}")
            continue
        try:
            rec = run_cell(arch, shape)
        except Exception as e:
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "ok": False, "chips": 1,
                   "error": f"{type(e).__name__}: {e}"}
            n_fail += 1
        out.write_text(json.dumps(rec, indent=1))
    print(f"done; failures={n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
