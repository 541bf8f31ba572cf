# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's ring collective matmuls (``parallel/overlap.py``) against
the JAX package's on the same inputs.

JAX runs its global wrappers (``tp_allgather_matmul``,
``tp_matmul_reducescatter``) and its per-device bodies under
``shard_map`` on the 8-device CPU mesh (``tests/conftest.py``); the port
runs every rank of the ring in this process (``InProcess``) through the
same wrappers and bodies, and over 2- and 4-rank gloo worlds
(``tests/torch_dist_worker.py`` scenario ``overlap``: ``P2P`` transfers,
bit-equal to ``InProcess``). f32 products summed in other orders: 2e-5
absolute and relative, JAX's own test bound; an exact-match fallback is
exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import torch_dist_worker as worker  # noqa: E402
from container_engine_accelerators_tpu.models import quantization as jq8  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu.parallel import overlap as jov  # noqa: E402
from container_engine_accelerators_tpu.utils.compat import shard_map  # noqa: E402
from container_engine_accelerators_tpu_torch.models.quantization import (  # noqa: E402
    Int8Weight,
)
from container_engine_accelerators_tpu_torch.obs import (  # noqa: E402
    collective as tcollective,
)
from container_engine_accelerators_tpu_torch.obs import trace as ttrace  # noqa: E402
from container_engine_accelerators_tpu_torch.ops import int8_matmul  # noqa: E402
from container_engine_accelerators_tpu_torch.parallel import overlap as tov  # noqa: E402
from container_engine_accelerators_tpu_torch.parallel.ring_attention import (  # noqa: E402
    InProcess,
)

TOL = dict(rtol=2e-5, atol=2e-5)


def mesh_n(n, axis="tp"):
    return Mesh(np.asarray(jax.devices()[:n]), (axis,))


def xw(m=16, k=24, n_cols=8, seed=0):
    """x (2, m, k) and w (k, n_cols), f32, from a numpy generator."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, m, k), dtype=np.float32),
            rng.standard_normal((k, n_cols), dtype=np.float32))


def t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_allgather_matmul_matches_jax(n, bidirectional):
    x, w = xw()
    want = jax.jit(lambda a, b: jov.tp_allgather_matmul(
        a, b, mesh_n(n), bidirectional=bidirectional))(x, w)
    got = tov.tp_allgather_matmul(t(x), t(w), {"tp": n},
                                  bidirectional=bidirectional)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_matmul_reducescatter_matches_jax(n, bidirectional):
    x, w = xw(k=32)
    want = jax.jit(lambda a, b: jov.tp_matmul_reducescatter(
        a, b, mesh_n(n), bidirectional=bidirectional))(x, w)
    got = tov.tp_matmul_reducescatter(t(x), t(w), {"tp": n},
                                      bidirectional=bidirectional)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_non_divisible_shapes_fall_back_exact():
    # M 15, N 7, K 30 do not divide over 4: the plain product, exactly.
    x, w = xw(m=15, k=30, n_cols=7)
    ref = t(x) @ t(w)
    for got in (tov.tp_allgather_matmul(t(x), t(w), {"tp": 4}),
                tov.tp_matmul_reducescatter(t(x), t(w), {"tp": 4}),
                tov.tp_allgather_matmul(t(x), t(w), {"tp": 4}, "nope"),
                tov.tp_allgather_matmul(t(x), t(w), None)):
        assert torch.equal(got, ref)
    np.testing.assert_allclose(ref.numpy(), np.asarray(
        jov.tp_allgather_matmul(jnp.asarray(x), jnp.asarray(w), mesh_n(4))),
        **TOL)


def test_reducescatter_rejects_ragged_rows_as_jax_does():
    x, w = xw(m=15, k=32)
    with pytest.raises(ValueError, match="must divide the ring"):
        shard_map(
            lambda xl, wl: jov.matmul_reducescatter(xl, wl, "tp", 4),
            mesh=mesh_n(4), in_specs=(P(None, None, "tp"), P("tp", None)),
            out_specs=P(None, "tp", None), check_vma=False,
        )(jnp.asarray(x), jnp.asarray(w))
    with pytest.raises(ValueError, match="must divide the ring"):
        tov.matmul_reducescatter(list(t(x).chunk(4, dim=-1)),
                                 list(t(w).chunk(4, dim=0)), InProcess(4))


@pytest.mark.parametrize("bidirectional", [False, True])
def test_fused_weights_share_one_ring_as_jax_s(bidirectional):
    """A tuple of weights: one output per weight from one ring (the
    q/k/v and w1/w3 fusions), each rank's the full rows of its column
    shard, against JAX's per-device body under shard_map."""
    x, w1 = xw()
    _, w2 = xw(n_cols=12, seed=1)
    o1, o2 = jax.jit(shard_map(
        lambda xl, a, b: jov.allgather_matmul(
            xl, (a, b), "tp", 4, bidirectional=bidirectional),
        mesh=mesh_n(4),
        in_specs=(P(None, "tp", None), P(None, "tp"), P(None, "tp")),
        out_specs=(P(None, None, "tp"), P(None, None, "tp")),
        check_vma=False,
    ))(x, w1, w2)
    outs = tov.allgather_matmul(
        list(t(x).chunk(4, dim=-2)),
        list(zip(t(w1).chunk(4, dim=-1), t(w2).chunk(4, dim=-1))),
        InProcess(4), bidirectional=bidirectional)
    got1 = torch.cat([o[0] for o in outs], dim=-1)
    got2 = torch.cat([o[1] for o in outs], dim=-1)
    np.testing.assert_allclose(got1.numpy(), np.asarray(o1), **TOL)
    np.testing.assert_allclose(got2.numpy(), np.asarray(o2), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["allgather", "reducescatter"])
def test_int8_weights_ride_the_ring_as_jax_s(dtype, kind):
    """JAX's int8 pytree as an Int8Weight: both rings against JAX's on
    the same q and scale. The reduce-scatter's partials are f32 on both
    sides (JAX's ``_chunk_mm(..., jnp.float32)``; here the kernel's f32
    epilogue, its plain version on the CPU), cast once at the end."""
    x, w = xw(k=32)
    wq = jq8.quantize_weight(jnp.asarray(w))
    jx = jnp.asarray(x, dtype)
    jfn = jov.tp_allgather_matmul if kind == "allgather" \
        else jov.tp_matmul_reducescatter
    tfn = tov.tp_allgather_matmul if kind == "allgather" \
        else tov.tp_matmul_reducescatter
    want = np.asarray(jax.jit(lambda a, q: jfn(a, q, mesh_n(4)))(jx, wq)
                      .astype(jnp.float32))
    tw = Int8Weight.from_jax_layout(t(wq["q"]), t(wq["scale"]))
    got = tfn(t(x).to(getattr(torch, dtype)), tw, {"tp": 4}).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        # One bf16 rounding of each f32 result on both sides: equal up
        # to a rounding boundary that the f32 sum order moves.
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-3)
    ref = int8_matmul.int8_mm_reference(t(x).to(getattr(torch, dtype)),
                                        tw.q, tw.scale).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-2)


def test_int8_reducescatter_partials_are_f32():
    x, w = xw(k=32)
    tw = Int8Weight.from_jax_layout(*(t(a) for a in jq8.quantize_weight(
        jnp.asarray(w)).values()))
    xb = t(x).to(torch.bfloat16)
    part = tov._chunk_mm(xb, tw, torch.float32)
    assert part.dtype == torch.float32
    want = int8_matmul.int8_mm_reference(xb, tw.q, tw.scale,
                                         out_dtype=torch.float32)
    assert want.dtype == torch.float32
    np.testing.assert_array_equal(part.numpy(), want.numpy())
    # The f32 output is the bf16 activations' product unrounded: the same
    # as f32 activations (bf16 → f32 is exact), the bf16 output rounded.
    np.testing.assert_array_equal(part.numpy(), int8_matmul.int8_mm_reference(
        xb.float(), tw.q, tw.scale).numpy())
    np.testing.assert_array_equal(
        part.to(torch.bfloat16).float().numpy(),
        int8_matmul.int8_mm(xb, tw.q, tw.scale).float().numpy())


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_gradients_through_both_rings_match_jax(n, bidirectional):
    x, w = xw(k=32)
    rng = np.random.default_rng(3)
    g_ag = rng.standard_normal((2, 16, 8), dtype=np.float32)
    mesh = mesh_n(n)

    def jgrads(fn):
        return jax.jit(jax.grad(
            lambda a, b: (fn(a, b, mesh, bidirectional=bidirectional)
                          * g_ag).sum(), argnums=(0, 1)))(x, w)

    for jfn, tfn in ((jov.tp_allgather_matmul, tov.tp_allgather_matmul),
                     (jov.tp_matmul_reducescatter,
                      tov.tp_matmul_reducescatter)):
        want = jgrads(jfn)
        tx, tw = t(x).requires_grad_(), t(w).requires_grad_()
        (tfn(tx, tw, {"tp": n}, bidirectional=bidirectional)
         * t(g_ag)).sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want[0]), **TOL)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want[1]), **TOL)


def test_ring_size_one_is_the_plain_product():
    x, w = xw()
    ring = InProcess(1)
    (out,) = tov.allgather_matmul([t(x)], [t(w)], ring)
    assert torch.equal(out, t(x) @ t(w))
    (out,) = tov.matmul_reducescatter([t(x)], [t(w)], ring)
    assert torch.equal(out, t(x) @ t(w))


def test_use_bidir_rules_are_jax_s():
    for args in [("auto", 4, 8), ("auto", 2, 8), ("auto", 4, 7),
                 (True, 2, 8), (True, 1, 8), (False, 8, 8), (True, 4, 3)]:
        assert tov._use_bidir(*args) == jov._use_bidir(*args), args
    assert tov.BIDIR_MIN_RING == jov.BIDIR_MIN_RING


def test_int8_weights_carry_no_gradient():
    x, w = xw(k=32)
    tw = Int8Weight.from_jax_layout(*(t(a) for a in jq8.quantize_weight(
        jnp.asarray(w)).values()))
    with pytest.raises(ValueError, match="serve only"):
        tov.allgather_matmul(list(t(x).requires_grad_().chunk(2, dim=-2)),
                             tov._split_cols(tw, 2), InProcess(2))


@pytest.mark.parametrize("kind", ["tp_allgather_matmul",
                                  "tp_matmul_reducescatter"])
def test_timed_only_when_someone_is_looking(kind):
    """Off: no span, no record. With the span tracer on: one event of
    the wrapper's name with the ring size and the bytes, as JAX's
    ``_timed_ring`` writes; with the collective instruments on: one
    latency sample."""
    x, w = xw(k=32)
    fn = getattr(tov, kind)
    ttrace.configure(enabled=False)
    fn(t(x), t(w), {"tp": 4})
    tracer = ttrace.configure()
    try:
        fn(t(x), t(w), {"tp": 4})
        events = [e for e in tracer.events() if e["name"] == kind]
    finally:
        ttrace.configure(enabled=False)
    assert len(events) == 1 and events[0]["args"]["ring"] == 4
    assert events[0]["args"]["bytes"] == 2 * 16 * (32 if kind.startswith(
        "tp_allgather") else 8) * 4
    tcollective.configure()
    try:
        fn(t(x), t(w), {"tp": 4})
        text = tcollective.get().registry.render().decode()
    finally:
        tcollective.configure(enabled=False)
    assert f'collective="{kind}"' in text


# -- the rings over processes ---------------------------------------------------

@pytest.fixture(scope="module")
def overlap_worlds(tmp_path_factory):
    return {world: worker.spawn("overlap", world,
                                str(tmp_path_factory.mktemp(f"ov{world}")))
            for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_gloo_ranks_equal_in_process_rings(overlap_worlds, world,
                                           bidirectional):
    """Each gloo rank's outputs and gradients (P2P transfers) are
    bit-equal to its rank's in the same rings run in one process, and
    the whole matches JAX."""
    ranks = overlap_worlds[world]
    want = worker.overlap_in_process(world)
    for key in want[bidirectional]:
        for rank, outs in enumerate(ranks):
            np.testing.assert_array_equal(
                outs[bidirectional][key], want[bidirectional][key][rank],
                err_msg=f"{key} rank {rank}")
    x, w1, w2, xr, wr = worker.overlap_inputs()
    full = np.concatenate([o[bidirectional]["ag0"] for o in ranks], axis=-1)
    np.testing.assert_allclose(full, np.asarray(
        jnp.asarray(x) @ jnp.asarray(w1)), **TOL)
    rs = np.concatenate([o[bidirectional]["rs"] for o in ranks], axis=-2)
    np.testing.assert_allclose(rs, np.asarray(
        jnp.asarray(xr) @ jnp.asarray(wr)), **TOL)


def test_transformer_mm_is_the_chunk_product_as_in_jax():
    """``transformer._mm``'s int8 branch and the ring's chunk product are
    one implementation in both packages."""
    from container_engine_accelerators_tpu_torch.models import (
        transformer as ttf,
    )

    x, w = xw(k=32)
    wq = jq8.quantize_weight(jnp.asarray(w))
    tw = Int8Weight.from_jax_layout(t(wq["q"]), t(wq["scale"]))
    np.testing.assert_array_equal(ttf._mm(t(x), tw).numpy(),
                                  tov._chunk_mm(t(x), tw, torch.float32)
                                  .numpy())
    np.testing.assert_allclose(ttf._mm(t(x), tw).numpy(),
                               np.asarray(jtf._mm(jnp.asarray(x), wq)), **TOL)
