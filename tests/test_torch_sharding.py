"""The port's sharding rules (``repro_torch.sharding``) against the JAX
reference's (``repro.sharding``), in process, on stub meshes.

For all ten configs at full size (the port's model on the ``meta``
device, the reference's parameters from ``jax.eval_shape``): the port's
spec of every parameter is the reference's spec of the same leaf, with
the leading ``None`` of the reference's stacked ``repeats`` axis dropped
for a block weight; every leaf has one; on the 16 x 16 production stub
every sharded dim divides; the bytes a rank holds are the reference's.
Then the expert axes (qwen3-moe against grok), the embedding and head,
``fsdp=False``, and ``data_specs`` / ``cache_specs`` (with
``kv_seq_shard`` both ways) on the (16, 16) and (2, 16, 16) stubs.
The placement of tensors by these specs, over real process groups, is
``tests/test_torch_sharded.py``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import sharding as JSH
from repro.configs import get_config as jget_config
from repro.configs import list_configs as jlist_configs
from repro.models import transformer as JT
from repro_torch import sharding as SH
from repro_torch.configs import get_config
from repro_torch.models import transformer as T

ARCHS = jlist_configs()
SIZES = {"data": 16, "model": 16}
POD_SIZES = {"pod": 2, "data": 16, "model": 16}


class _MeshStub:
    """What the reference reads of a mesh: ``shape`` (``_fit_spec``,
    ``dp_size``) and ``axis_names`` (``batch_axes``)."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def _ref_specs(jcfg, mesh=None) -> dict:
    """``{reference path: (spec tuple, leaf shape, bytes an element)}``."""
    params = jax.eval_shape(lambda: JT.init_params(
        jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16))
    specs = JSH.param_specs(params, jcfg, mesh)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    return {JSH._path_str(path): (tuple(spec), leaf.shape,
                                  leaf.dtype.itemsize)
            for (path, leaf), spec in zip(leaves, spec_leaves)}


def _port_names(ref: dict, cfg) -> dict:
    """``{port parameter name: (reference path, stacked)}``: a block leaf
    ``blocks/b<i>/<rest>`` of R repeats is layers ``r * period + i``;
    norm leaves are the norm modules' ``scale``."""
    def leaf(rest):
        head, _, name = rest.rpartition("/")
        if name.startswith("norm") or name == "final_norm":
            name += ".scale"
        return ".".join(filter(None, head.split("/") + [name]))

    out = {}
    for path, (_, shape, _) in ref.items():
        if path == "embed/table":
            out["embed"] = (path, False)
        elif path == "lm_head/head":
            out["lm_head"] = (path, False)
        elif "blocks/b" in path:
            stack, _, rest = path.partition("blocks/b")
            i, _, rest = rest.partition("/")
            period = 1 if stack.startswith("encoder") else len(cfg.pattern)
            for r in range(shape[0]):
                out[f"{stack.replace('/', '.')}blocks.{r * period + int(i)}."
                    f"{leaf(rest)}"] = (path, True)
        else:
            out[leaf(path)] = (path, False)
    return out


def _port_specs(cfg, mesh=None) -> tuple:
    model = T.Transformer(cfg, device="meta", dtype=torch.bfloat16)
    return SH.param_specs(model, cfg, mesh), dict(model.named_parameters())


def _held_to_reference(cfg, jcfg, sizes=None):
    """Every port spec against the reference's (one leading None fewer
    for a block weight); every leaf covered, on both sides."""
    ref = _ref_specs(jcfg, _MeshStub(sizes) if sizes else None)
    specs, params = _port_specs(cfg, sizes)
    names = _port_names(ref, cfg)
    assert sorted(specs) == sorted(names) == sorted(params)
    for name, spec in specs.items():
        path, stacked = names[name]
        want = ref[path][0]
        if stacked:
            assert want[0] is None, (name, want)
            want = want[1:]
        assert spec == want, (name, spec, want)
        assert len(spec) == params[name].ndim
    return specs, params


def _per_rank_bytes(specs, params, sizes) -> tuple:
    total = held = 0
    for name, p in params.items():
        n = p.numel() * p.element_size()
        div = math.prod(sizes[a] for ax in specs[name]
                        for a in SH.entry_axes(ax))
        total += n
        held += n // div
    return total, held


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference_on_every_leaf(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    _held_to_reference(cfg, jcfg)  # the rules alone
    specs, params = _held_to_reference(cfg, jcfg, SIZES)
    for name, spec in specs.items():  # divisible on the production mesh
        for dim, ax in enumerate(spec):
            n = math.prod(SIZES[a] for a in SH.entry_axes(ax))
            assert params[name].shape[dim] % n == 0, (name, spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_per_rank_bytes_match_reference(arch):
    """The bytes one rank of the 16 x 16 mesh holds, from the port's
    specs, equal the reference's arithmetic over its own leaves."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    specs, params = _port_specs(cfg, SIZES)
    ref = _ref_specs(jcfg, _MeshStub(SIZES))
    want_total = want_held = 0
    for spec, shape, itemsize in ref.values():
        n = math.prod(shape) * itemsize
        want_total += n
        want_held += n // math.prod(SIZES[a] for ax in spec
                                    for a in SH.entry_axes(ax))
    assert _per_rank_bytes(specs, params, SIZES) == (want_total, want_held)


def test_fsdp_sharding_bounds_per_rank_bytes():
    """qwen3-8b on the 16 x 16 mesh: a rank holds under total / 200 (the
    reference's bound: only norms and scales replicate)."""
    cfg = get_config("qwen3-8b")
    specs, params = _port_specs(cfg)
    total, held = _per_rank_bytes(specs, params, SIZES)
    assert held <= total / 200


def test_moe_shard_axis_choices():
    """qwen3-moe's experts over `model`, grok's expert F over `model`."""
    qwen, _ = _port_specs(get_config("qwen3-moe-30b-a3b"))
    grok, _ = _port_specs(get_config("grok-1-314b"))
    assert qwen["blocks.0.ffn.wi"] == ("model", "data", None)
    assert qwen["blocks.0.ffn.wd"] == ("model", None, "data")
    assert qwen["blocks.0.ffn.router"] == ("data", None)
    assert grok["blocks.0.ffn.wi"] == (None, "data", "model")
    assert grok["blocks.0.ffn.wd"] == (None, "model", "data")


def test_embed_and_head_specs():
    specs, _ = _port_specs(get_config("qwen3-8b"))
    assert specs["embed"] == ("model", "data")
    assert specs["lm_head"] == ("data", "model")
    # whisper's vocab of 51865 does not split 16 ways: its axis drops
    whisper, _ = _port_specs(get_config("whisper-small"), SIZES)
    assert whisper["embed"] == (None, "data")


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen3-moe-30b-a3b"])
def test_fsdp_false_drops_the_data_axis(arch):
    cfg = dataclasses.replace(get_config(arch), fsdp=False)
    jcfg = dataclasses.replace(jget_config(arch), fsdp=False)
    specs, _ = _held_to_reference(cfg, jcfg, SIZES)
    assert all("data" not in SH.entry_axes(ax)
               for spec in specs.values() for ax in spec)
    assert specs["blocks.0.mixer.wq"] == (None, "model")


@pytest.mark.parametrize("sizes", [SIZES, POD_SIZES], ids=["16x16",
                                                           "2x16x16"])
@pytest.mark.parametrize("B", [32, 1])
def test_data_specs_match_reference(sizes, B):
    batch = {"tokens": torch.zeros((B, 64), dtype=torch.int32),
             "labels": torch.zeros((B, 64), dtype=torch.int32),
             "frontend": torch.zeros((B, 8, 16))}
    got = SH.data_specs(sizes, batch)
    want = JSH.data_specs(_MeshStub(sizes), {
        k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
        for k, v in batch.items()})
    # the reference writes a replicated spec as P(), the port as Nones
    assert got == {k: tuple(v) + (None,) * (batch[k].ndim - len(v))
                   for k, v in want.items()}
    assert SH.batch_axes(sizes) == JSH.batch_axes(_MeshStub(sizes))
    assert SH.dp_size(sizes) == JSH.dp_size(_MeshStub(sizes))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                      f"{prefix}/{k}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("kv_seq_shard", [False, True])
@pytest.mark.parametrize("B", [32, 1])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "jamba-v0.1-52b",
                                  "xlstm-125m"])
def test_cache_specs_match_reference(arch, B, kv_seq_shard):
    """Per layer, the port's cache specs are the reference's stacked ones
    without the repeats axis (attention K/V, mamba and xLSTM states)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    cache = T.init_cache(cfg, B, 256, torch.bfloat16, device="meta")
    got = SH.cache_specs(SIZES, cache, B, kv_seq_shard)
    jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, B, 256,
                                                  jnp.bfloat16))
    want = jax.tree.map(tuple, JSH.cache_specs(
        _MeshStub(SIZES), jcache, B, kv_seq_shard),
        is_leaf=lambda x: isinstance(x, P))
    period = len(cfg.pattern)
    assert len(got) == len(cache) == cfg.n_layers
    for layer, specs in enumerate(got):
        ref = _flat(want[f"b{layer % period}"])
        mine = _flat(specs)
        assert [k for k, _ in mine] == [k for k, _ in ref], layer
        for (k, spec), (_, w) in zip(mine, ref):
            assert w[0] is None and spec == w[1:], (layer, k, spec, w)
