"""The port's sharding rules against the reference's, with no process group.

``repro_torch.distributed.sharding`` resolves specs from a mesh's axis names
and sizes alone; the reference's side runs on a ``jax.sharding.AbstractMesh``
of the same names and sizes.  For all 10 configurations' smoke models, on
the meshes (4, 2) ("data", "model"), (2, 2, 2) ("replica", "shard",
"model"), (2, 4, 4) ("pod", "data", "model") and (4, 2) under
``MeshAxes.dp_over_model``:

* ``describe()`` of the parameter and cache shardings equals the
  reference's, leaf for leaf.  The port's tree is unstacked; the reference's
  rules are applied to the reference's tree unstacked the same way (the
  rules see a leaf at its own rank there).
* The reference's stacked tree, its leading (layer) ``None``s dropped, gives
  the same specs, but for one reference-side finding pinned here: a stacked
  2-D leaf whose name also has a 3-D rule (the dense MLP's ``w_gate`` /
  ``w_up`` / ``w_down``, whose 3-D rule is the MoE experts') takes the 3-D
  rule on its stacked shape, so the layer axis gets the experts' placement.
* ``batch_shardings`` and ``axes.shard``'s resolution, non-dividing dims
  included (``shard`` leaves such a dim unconstrained, ``_resolve``
  replicates it).
"""
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.distributed import axes as jax_axes  # noqa: E402
from repro.distributed import sharding as jax_sharding  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import axes, sharding  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime.serve import _cache_shapes  # noqa: E402
from repro_torch.runtime.train import param_shapes  # noqa: E402

MESHES = {
    "data4_model2": ({"data": 4, "model": 2}, None),
    "rdp222": ({"replica": 2, "shard": 2, "model": 2}, None),
    "pod2_data4_model4": ({"pod": 2, "data": 4, "model": 4}, None),
    "dp_over_model": ({"data": 4, "model": 2}, "dp_over_model"),
}
DECODE = (8, 16)  # batch, max_len of the cache cell


def _abstract(sizes: dict) -> AbstractMesh:
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _axes_pair(sizes: dict, how):
    if how is None:
        return None, None
    return (getattr(jax_sharding.MeshAxes, how)(_abstract(sizes)),
            getattr(sharding.MeshAxes, how)(sizes))


def _dotted(keystr: str) -> str:
    """``"['layers'][0]['attn']['wq']"`` -> ``"layers.0.attn.wq"``."""
    return ".".join(a or b for a, b in re.findall(r"\['([^']*)'\]|\[(\d+)\]", keystr))


def _nest(flat: dict):
    """A nested tree of dicts (lists where every key is an index) from dotted paths."""
    root: dict = {}
    for path, leaf in flat.items():
        node, parts = root, path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}

    return lists(root)


def _align(ref, port):
    """The reference's tree unstacked to the port's structure: where the port
    has a list and the reference one stacked node, each entry is the
    reference's node at that index (shapes without the leading axis)."""
    if isinstance(port, list):
        if isinstance(ref, list):
            return [_align(r, p) for r, p in zip(ref, port)]
        return [_align(jax.tree.map(lambda x, i=i: jax.ShapeDtypeStruct(x.shape[1:], x.dtype),
                                    ref), p) for i, p in enumerate(port)]
    if isinstance(port, dict):
        return {k: _align(ref[k], v) for k, v in port.items()}
    return ref


def _ref_describe(shardings) -> dict:
    return {_dotted(k): v for k, v in jax_sharding.describe(shardings).items()}


def _port_flat_cache(cache) -> dict:
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        else:
            out[prefix.rstrip(".")] = node

    walk(cache, "")
    return out


def _models(arch: str):
    return (jax_build_model(jax_get_config(arch, smoke=True)),
            build_model(get_config(arch, smoke=True)))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_specs_match_reference(arch, mesh_name):
    sizes, how = MESHES[mesh_name]
    amesh = _abstract(sizes)
    jax_ax, port_ax = _axes_pair(sizes, how)
    ref_model, port_model = _models(arch)

    port_params = param_shapes(port_model)
    got = sharding.describe(sharding.param_shardings(sizes, port_params, port_ax))
    ref_tree = _align(ref_model.param_specs(), _nest(port_params))
    want = _ref_describe(jax_sharding.param_shardings(amesh, ref_tree, jax_ax))
    assert got == want

    if ref_model.cfg.family == "encoder":  # no decode cache
        return
    port_cache = _cache_shapes(port_model, ShapeConfig("d", DECODE[1], DECODE[0], "decode"))
    got_c = sharding.describe(sharding.cache_shardings(sizes, port_cache, port_ax))
    ref_cache = _align(ref_model.cache_specs(JaxShapeConfig("d", DECODE[1], DECODE[0],
                                                            "decode")), port_cache)
    want_c = _ref_describe(jax_sharding.cache_shardings(amesh, ref_cache, jax_ax))
    assert got_c == want_c
    assert set(got_c) == set(_port_flat_cache(port_cache))


def _stacked_key(path: str) -> str:
    """A port leaf's key in the reference's stacked tree: the layer (or
    group) index after the first part dropped (``layers.0.mlp.w_gate`` ->
    ``layers.mlp.w_gate``)."""
    parts = path.split(".")
    return ".".join(parts[:1] + parts[2:])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_stacked_reference_specs_drop_to_the_ports(arch):
    """The reference's own stacked tree against the port's unstacked one,
    leading Nones dropped, on (4, 2): equal but for the dense-MLP finding."""
    sizes = MESHES["data4_model2"][0]
    ref_model, port_model = _models(arch)
    stacked = ref_model.param_specs()
    ref_sh = jax_sharding.param_shardings(_abstract(sizes), stacked)
    ref_flat = {
        _dotted(jax.tree_util.keystr(p)): (x.shape, tuple(s.spec))
        for (p, x), (_, s) in zip(jax.tree_util.tree_flatten_with_path(stacked)[0],
                                  jax.tree_util.tree_flatten_with_path(ref_sh)[0])}
    port_shapes = param_shapes(port_model)
    port = sharding.param_shardings(sizes, port_shapes)
    quirks = set()
    for path, sh in port.items():
        key = path if path in ref_flat else _stacked_key(path)
        shape, parts = ref_flat[key]
        lead = len(shape) - port_shapes[path].dim()
        parts = parts + (None,) * (len(shape) - len(parts))  # P() is P(None, ...)
        spec = tuple(sh.spec) + (None,) * (port_shapes[path].dim() - len(sh.spec))
        if parts[:lead] == (None,) * lead and parts[lead:] == spec:
            continue
        name = key.rsplit(".", 1)[-1]
        # the stacked shape met a rule of its own rank: the 3-D (expert) rule
        assert lead and len(shape) in jax_sharding._PARAM_RULES[name], (path, parts, spec)
        quirks.add(name)
    # exactly the stacked dense (gated) MLP's leaves: the MoE experts' 3-D
    # rule is not theirs to take
    assert quirks == {k.rsplit(".", 1)[-1] for k in ref_flat
                      if k.startswith(("layers.", "groups.")) and ".mlp.w_" in k
                      and k.rsplit(".", 1)[-1] in ("w_gate", "w_up", "w_down")}, quirks


@pytest.mark.parametrize("batch", [8, 6])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_shardings_match_reference(mesh_name, batch):
    sizes, how = MESHES[mesh_name]
    jax_ax, port_ax = _axes_pair(sizes, how)
    cfg = jax_get_config("qwen2-vl-7b", smoke=True)
    spec = jax_build_model(cfg).input_specs(JaxShapeConfig("t", 16, batch, "train"))
    want = {k: str(s.spec) for k, s in
            jax_sharding.batch_shardings(_abstract(sizes), spec, jax_ax).items()}
    got = {k: str(s.spec) for k, s in sharding.batch_shardings(
        sizes, {k: torch.Size(v.shape) for k, v in spec.items()}, port_ax).items()}
    assert got == want


SHARD_CASES = [
    # (shape, roles, batch axes, model axis, seq)
    ((8, 16, 64), ("batch", None, "model"), ("data",), "model", False),
    ((6, 16, 3), ("batch", None, "model"), ("data",), "model", False),  # non-dividing
    ((8, 16, 64), ("batch", "residual", None), ("data",), "model", False),
    ((8, 16, 64), ("batch", "residual", None), ("data",), "model", True),
    ((8, 15, 64), ("batch", "residual", None), ("data",), "model", True),
    ((8, 16, 64), ("batch", None, "model"), (), None, False),  # nothing mapped
    ((16, 4), ("batch", "model"), ("pod", "data"), "model", False),
    ((4, 4), ("batch", "model"), ("pod", "data"), "model", False),
]


@pytest.mark.parametrize("case", range(len(SHARD_CASES)))
def test_shard_resolution_matches_reference(case, monkeypatch):
    shape, roles, batch, model, seq = SHARD_CASES[case]
    sizes = {"pod": 2, "data": 4, "model": 2} if "pod" in batch else {"data": 4, "model": 2}
    monkeypatch.setattr(jax_axes, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax_axes.jax.lax, "with_sharding_constraint", lambda x, s: s)
    with jax_axes.logical_axes(_abstract(sizes), batch, model, seq):
        want = jax_axes.shard(jnp.zeros(shape), *roles)
    x = torch.zeros(shape)
    with axes.logical_axes(sizes, batch, model, seq):
        got = axes.shard_spec(axes.current(), shape, roles)
        assert axes.shard(x, *roles) is x  # a plain tensor: a hint, never a value
    assert str(got) == str(want)
    assert axes.shard(x, *roles) is x  # no context


def test_placements_put_the_first_axis_major():
    from torch.distributed.tensor import Replicate, Shard

    sizes = {"pod": 2, "data": 4, "model": 2}
    got = sharding.placements(sharding.PartitionSpec(("pod", "data"), "model"), sizes)
    assert got == (Shard(0), Shard(0), Shard(1))
    assert sharding.placements(sharding.PartitionSpec(), sizes) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements(sharding.PartitionSpec(("data", "pod")), sizes)
    # rank (pod 1, data 2, model 0) holds chunk 1 * 4 + 2 of dim 0 and half 0 of dim 1
    sl = sharding.local_slice((16, 8), ("pod", "data") and (("pod", "data"), "model"), sizes,
                              (1, 2, 0))
    assert sl == (slice(12, 14), slice(0, 4))
