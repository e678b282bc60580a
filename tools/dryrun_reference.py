"""The JAX package's dry-run numbers that the port's dry run
(``repro_torch.launch.dryrun``) is held against, and both packages'
per-rank bytes side by side on the production mesh.

    PYTHONPATH=src python tools/dryrun_reference.py --json --plan attn_seq_shard  # the test oracle
    PYTHONPATH=src python tools/dryrun_reference.py --layouts  # a markdown table at (16, 16)

``--json`` prints one JSON object: the JAX dry run (``build_lowered`` and
``analyse``, compiled) on a 2 x 2 host mesh for tinyllama-1.1b at
``decode_32k`` and ``prefill_32k`` and for deepseek-v2-lite-16b at
``decode_32k`` (with ``--plan attn_seq_shard``, the tinyllama pairs under
the plan knob too: it lowers at the installed jax, with the FLOPs of the
pairs without it); and the per-device bytes of the JAX leaves' shards under
the reference's own shardings (``params_shardings``, ``cache_shardings``)
on that mesh: parameters and cache.

The meshes are ``jax.sharding.Mesh`` over host devices, whose axes are
Auto, as ``jax.make_mesh``'s were before jax 0.5 (``requirements-ci.txt``
pins ``<0.5``). At the installed jax, ``jax.make_mesh`` (the reference's
``make_debug_mesh``) makes Explicit axes, under which deepseek's MLA
cache update raises ``ShardingTypeError`` (ROADMAP.md, Queue 3);
tinyllama's numbers are the same under both.

``--layouts`` prints, for every arch at ``decode_32k`` and ``long_500k`` on
(16, 16), the reference's per-rank parameter and cache bytes beside the
port's (``launch.dryrun.rank_bytes``) and their ratio. Both are counts
from shapes; the JAX package runs on the host CPU (512 host devices, as
its own dry run sets them) and never on a card.
"""
from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs.base import ARCHS, SHAPES, get_config  # noqa: E402
from repro.launch import dryrun as dr  # noqa: E402
from repro.launch.mesh import batch_axes_for  # noqa: E402
from repro.models import model as model_lib  # noqa: E402
from repro.sharding.partition_specs import cache_shardings, params_shardings  # noqa: E402


def host_mesh(data: int, model: int):
    """A (data, model) mesh of the first data * model host devices."""
    devs = np.array(jax.devices()[:data * model]).reshape(data, model)
    return Mesh(devs, ("data", "model"))


def compiled(arch: str, shape: str, mesh, plan=None) -> dict:
    lowered, _ = dr.build_lowered(arch, shape, mesh=mesh, plan=plan)
    st = dr.analyse(lowered, lowered.compile(), mesh.size)
    return {"flops": st["flops"], "argument_size_in_bytes": st["argument_size_in_bytes"],
            "collectives": st["collectives"]}


def shard_bytes(arch: str, shape_name: str, mesh) -> dict:
    """Per-device bytes of the reference's parameter and cache leaves under
    its own shardings (the config as its dry run cuts it for the shape)."""
    cfg, _ = dr.config_for_shape(get_config(arch), shape_name)
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    baxes = batch_axes_for(mesh)
    p = jax.eval_shape(functools.partial(model_lib.init_params, cfg=cfg),
                       jax.ShapeDtypeStruct((2,), jnp.uint32))
    c = jax.eval_shape(functools.partial(model_lib.init_cache, cfg, B, S, enc_len=dr.ENC_FRAMES))
    psh = params_shardings(p, cfg, mesh, batch_axes=baxes)
    csh = cache_shardings(c, cfg, mesh, B, batch_axes=baxes)

    def total(tree, shs):
        return sum(int(np.prod(sh.shard_shape(leaf.shape))) * leaf.dtype.itemsize
                   for leaf, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(shs)))
    return {"params": total(p, psh), "cache": total(c, csh)}


def oracle(plan=None) -> dict:
    """The oracle's pairs; with ``plan`` (the reference's plan knobs, as
    its ``--plan`` takes them) the tinyllama pairs again under that plan,
    keyed "<arch> <shape> plan"."""
    m22 = host_mesh(2, 2)
    out = {}
    for arch, shape in (("tinyllama-1.1b", "decode_32k"), ("tinyllama-1.1b", "prefill_32k"),
                        ("deepseek-v2-lite-16b", "decode_32k")):
        out[f"{arch} {shape}"] = compiled(arch, shape, m22)
        if plan and arch == "tinyllama-1.1b":
            out[f"{arch} {shape} plan"] = compiled(arch, shape, m22, plan)
    for arch in ("tinyllama-1.1b", "deepseek-v2-lite-16b"):
        out[f"{arch} decode_32k shards"] = shard_bytes(arch, "decode_32k", m22)
    return out


def layouts() -> str:
    """The reference's per-rank bytes beside the port's at (16, 16)."""
    from repro_torch.configs.base import get_config as port_config
    from repro_torch.launch.dryrun import config_for_shape, rank_bytes
    mesh = host_mesh(16, 16)
    gib = 2 ** 30
    rows = ["| arch | shape | params GiB ref / port | ratio | cache GiB ref / port | ratio |",
            "|---|---|---|---|---|---|"]
    for arch in ARCHS:
        for shape in ("decode_32k", "long_500k"):
            cfg, _ = config_for_shape(port_config(arch), shape)
            if cfg is None:
                continue
            ref = shard_bytes(arch, shape, mesh)
            spec = SHAPES[shape]
            port = rank_bytes(cfg, {"data": 16, "model": 16}, 0, spec.global_batch,
                              spec.seq_len, dr.ENC_FRAMES if cfg.is_encoder_decoder else 0)
            rows.append(f"| {arch} | {shape} | {ref['params'] / gib:.3f} / "
                        f"{port['params'] / gib:.3f} | {port['params'] / ref['params']:.3g} | "
                        f"{ref['cache'] / gib:.3f} / {port['cache'] / gib:.3f} | "
                        f"{port['cache'] / ref['cache']:.3g} |")
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--layouts", action="store_true")
    ap.add_argument("--plan", default="", help="with --json: plan knobs, e.g. attn_seq_shard")
    args = ap.parse_args()
    if args.json:
        plan = {k: True for k in filter(None, args.plan.split(","))}
        print("ORACLE " + json.dumps(oracle(plan)))
    if args.layouts:
        print(layouts())


if __name__ == "__main__":
    main()
