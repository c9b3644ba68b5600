"""Port parity: meshes, the logical-axis rules and placement, against the
JAX package's ``launch/mesh.py`` and ``launch/sharding.py``, on the CPU.

The rules and every leaf's spec must equal the reference's for every
registered arch on the production meshes and small host meshes.  The
reference's ``make_rules`` reads only ``mesh.axis_names`` and
``mesh.devices.shape``, so a stand-in with those two attributes stands for
its 256- and 512-device meshes; the port's meshes are built over logical
CPU devices (``launch.mesh.logical_devices``), the port's counterpart of
``--xla_force_host_platform_device_count``.
"""
import types

import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS, get_config as jax_config
from repro.launch import sharding as JS
from repro.models import cache_axes as jax_cache_axes
from repro.models import paged_pool_axes as jax_pool_axes
from repro.models import param_axes as jax_param_axes
import repro_torch.models as P
from repro_torch.configs.registry import get_config
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import (LogicalDevice, Mesh, local_devices,
                                     logical_devices, make_host_mesh,
                                     make_production_mesh, mesh_slices)

torch.set_num_threads(1)

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _port_mesh(shape, names) -> Mesh:
    n = int(np.prod(shape))
    with logical_devices(n):
        if shape == (16, 16):
            return make_production_mesh()
        if shape == (2, 16, 16):
            return make_production_mesh(multi_pod=True)
        return make_host_mesh(n, model=shape[-1])


def _ref_leaves(tree, prefix="") -> dict:
    """Axes leaves of a JAX axes tree by ``/``-joined path (dict keys
    sorted, as ``models.stacked_leaves`` names them)."""
    if JS._is_axes_leaf(tree):
        return {prefix: tree}
    kids = (sorted(tree.items()) if isinstance(tree, dict)
            else enumerate(tree))
    out = {}
    for k, v in kids:
        out.update(_ref_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _stacked_axes(axes_tree, cfg) -> dict:
    """The port's axes tree by JAX leaf name: a stacked leaf's per-layer
    axes (every layer's the same) with the reference's leading 'layers'."""
    wrapped = S.map_axes(S._Axes, axes_tree)
    out = {}
    for name, v in P.stacked_leaves(wrapped, cfg).items():
        if isinstance(v, tuple):
            assert len({a.axes for a in v}) == 1, name
            out[name] = ("layers",) + v[0].axes
        else:
            out[name] = v.axes
    return out


def _pool_by_name(port_pools, cfg) -> dict:
    """The port's per-layer pool axes by the JAX pool tree's leaf names."""
    tree = {"layers": port_pools}
    out = {}
    for name, v in P.stacked_leaves(S.map_axes(S._Axes, tree), cfg).items():
        name = name.replace("segments/", "")
        out[name] = (("layers",) + v[0].axes if isinstance(v, tuple)
                     else v.axes)
    return out


def _same_specs(port: dict, ref: dict, port_rules, ref_rules, what):
    assert sorted(port) == sorted(ref), what
    for name, axes in ref.items():
        assert port[name] == axes, (what, name)
        want = tuple(JS.leaf_spec(axes, ref_rules))
        got = S.leaf_spec(axes, port_rules)
        assert got == want, (what, name, got, want)
        if axes and axes[0] == "layers":
            # the port's per-layer leaf drops the stacked axis, which no
            # rule shards
            assert want[0] is None
            assert S.leaf_spec(axes[1:], port_rules) == want[1:]


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_leaf_specs_match_the_reference(arch, mesh_id):
    shape, names = MESHES[mesh_id]
    fake = types.SimpleNamespace(axis_names=names,
                                 devices=types.SimpleNamespace(shape=shape))
    mesh = _port_mesh(shape, names)
    assert mesh.axis_names == names and mesh.devices.shape == shape
    jcfg, pcfg = jax_config(arch), get_config(arch)
    params_ref = _ref_leaves(jax_param_axes(jcfg))
    params_port = _stacked_axes(P.param_axes(pcfg), pcfg)
    caches_ref = _ref_leaves(jax_cache_axes(jcfg))
    caches_port = _pool_by_name(P.cache_axes(pcfg), pcfg)
    for batch in (None, 1, 256):
        for fsdp in (False, True):
            ref_rules = JS.make_rules(jcfg, fake, batch=batch, fsdp=fsdp)
            port_rules = S.make_rules(pcfg, mesh, batch=batch, fsdp=fsdp)
            assert port_rules == ref_rules, (batch, fsdp)
            _same_specs(params_port, params_ref, port_rules, ref_rules,
                        "params")
            _same_specs(caches_port, caches_ref, port_rules, ref_rules,
                        "caches")
            for kv in ("bfloat16", "int8"):
                _same_specs(_pool_by_name(P.paged_pool_axes(pcfg, kv), pcfg),
                            _ref_leaves(jax_pool_axes(jcfg, kv)),
                            port_rules, ref_rules, f"pool {kv}")
            for opt in ("adamw", "adafactor"):
                ref = JS.opt_state_axes(opt, jax_param_axes(jcfg))
                port = S.opt_state_axes(opt, P.param_axes(pcfg), pcfg)
                for field in ("mu", "nu"):
                    ref_f = _ref_leaves({"p": getattr(ref, field)})
                    port_f = getattr(port, field)
                    ref_f = {k[2:]: v for k, v in ref_f.items()}
                    got = {}
                    for name, v in port_f.items():
                        if isinstance(v, dict):
                            got.update({f"{name}/{k}": a
                                        for k, a in v.items()})
                        elif v and isinstance(v[0], tuple):   # stacked
                            got[name] = ("layers",) + v[0]
                        else:
                            got[name] = v
                    # the reference's flatten names the segment leaves
                    # by their tuple indices, as stacked_leaves does
                    _same_specs(got, ref_f, port_rules, ref_rules,
                                f"{opt} {field}")


def test_leaf_spec_dedup_and_priority():
    """Twins of the reference's ``test_leaf_spec_dedups_mesh_axes`` and
    ``test_leaf_spec_priority_order``."""
    rules = {"embed": "model", "ffn": "model", "heads": "model", None: None}
    assert S.leaf_spec(("embed", "ffn"), rules) == (None, "model")
    rules = {"expert": "data", "embed": "data", "ffn": "model", None: None}
    assert S.leaf_spec(("expert", "embed", "ffn"), rules) == \
        ("data", None, "model")


def test_make_host_mesh_rejects_non_divisible():
    with pytest.raises(ValueError,
                       match=r"model=4 does not divide n_devices=6"):
        make_host_mesh(6, model=4)
    with pytest.raises(ValueError, match=r"strand 2"):
        make_host_mesh(6, model=4)


def test_mesh_slices_are_disjoint_and_bounded():
    with logical_devices(8):
        n = len(local_devices())
        slices = mesh_slices(2, 1)
        sets = [set(m.devices.flat) for m in slices]
        assert sets[0].isdisjoint(sets[1])
        assert all(m.devices.shape == (1, 1) for m in slices)
        wide = mesh_slices(2, 4)
        assert set(wide[0].devices.flat).isdisjoint(wide[1].devices.flat)
        assert wide[0].axis_names == ("data", "model")
        with pytest.raises(ValueError, match="available"):
            mesh_slices(n + 1, 1)
        with pytest.raises(ValueError, match="positive"):
            mesh_slices(0, 1)


def test_local_devices_default_and_scoped_override():
    """By default one logical device per card (one on the CPU without a
    card); only inside ``logical_devices`` do several share a device, and
    the scope ends with the block."""
    default = local_devices()
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert len(default) == max(cards, 1)
    with logical_devices(4, "cpu") as devs:
        assert local_devices() == devs
        assert [d.index for d in devs] == [0, 1, 2, 3]
        assert {d.device for d in devs} == {torch.device("cpu")}
        with logical_devices(2):
            assert len(local_devices()) == 2
        assert len(local_devices()) == 4
    assert local_devices() == default
    assert LogicalDevice(0, torch.device("cpu")) == devs[0]


@pytest.mark.parametrize("spec", [(None, "model"), ("model", None), (),
                                  (("data", "model"), None)])
def test_place_gather_round_trip(spec):
    """A placed tensor gathers back bit for bit; each shard is its own
    contiguous copy; a replicated dim gives every shard the same bits; a
    mesh axis of size 1 splits nothing."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((8, 12), generator=g).to(torch.bfloat16)
    with logical_devices(4):
        mesh = make_host_mesh(4, model=2)
    placed = S.place(x, mesh, spec)
    assert len(placed.shards) == 4
    assert all(t.is_contiguous() for t in placed.shards)
    ptrs = {t.data_ptr() for t in placed.shards}
    assert len(ptrs) == 4 and x.data_ptr() not in ptrs
    assert torch.equal(placed.gather("cpu").view(torch.int16),
                       x.view(torch.int16))
    for region, shard in zip(placed.placement.slices(x.shape),
                             placed.shards):
        assert torch.equal(shard, x[region])
    if spec == ():
        assert all(torch.equal(t, x) for t in placed.shards)
    with logical_devices(2):
        one = make_host_mesh(2, model=1)            # (2, 1): model size 1
    kept = S.place(x, one, (None, "model"))
    assert all(t.shape == x.shape for t in kept.shards)
    assert not kept.placement.splits(2)
    with pytest.raises(ValueError, match="not divisible"):
        S.place(torch.zeros(3, 4), mesh, ("model",))
