"""The cached attention's op (``repro_torch::decode_attention``,
``repro_torch/kernels/decode_attention.py``) on the CPU, where it takes
its plain path, and on ``meta``:

* its ``vmap`` rule, on a period view of a replica-stacked cache leaf
  ``(R, P, B, L, H, D)`` with the lengths shared by every replica or
  per replica, equals the per-replica loop bit for bit, and so does a
  nested ``vmap`` and a cache the ``vmap`` does not batch; a cache that
  no view folds is refused;
* ``verify_attention`` at ``Sq = 1`` equals ``decode_attention`` bit for
  bit, alone and under ``vmap``; no mask equals the whole length;
* the op's plain path is ``models/attention.py``'s ``einsum`` body on
  the mask the lengths give;
* its fake gives the kernel's output shape and dtype on ``meta`` and
  counts one launch, under ``vmap`` too;
* the launch harness's dry-run of a robust decode step still traces,
  with one launch per attention call of a layer (two for an ``xattn``
  layer, none for a Mamba layer), at the serving cell's shapes too;
* the pieces of the length depend on ``L`` alone; the kernel's checks
  refuse what it does not take.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.agg import AggSpec  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.attention import (_cached_attention,  # noqa: E402
                                          decode_attention,
                                          verify_attention)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _randn(*shape, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


def _lengths(shape, top, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(1, top + 1, shape, generator=g, dtype=torch.int32)


# replicas, periods, slots, length, KV heads, G, Sq, head dim
CASES = {
    "decode": (3, 2, 4, 40, 2, 1, 1, 16),
    "gqa": (2, 3, 3, 33, 2, 4, 1, 8),
    "verify": (3, 2, 2, 24, 1, 2, 3, 32),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_replica", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_vmap_rule_on_a_period_view_equals_the_replica_loop(case,
                                                           per_replica,
                                                           dtype):
    r, p, b, length, hkv, g, sq, d = CASES[case]
    k = _randn(r, p, b, length, hkv, d, seed=1, dtype=dtype)
    v = _randn(r, p, b, length, hkv, d, seed=2, dtype=dtype)
    q = _randn(r, b, sq, hkv * g, d, seed=3, dtype=dtype)
    lens = _lengths((r, b, sq) if per_replica else (b, sq), length, 4)
    period = p - 1
    if per_replica:
        got = torch.func.vmap(lambda qq, kk, vv, ll: verify_attention(
            qq, kk[period], vv[period], ll))(q, k, v, lens)
        want = [verify_attention(q[i], k[i, period], v[i, period], lens[i])
                for i in range(r)]
    else:
        got = torch.func.vmap(lambda qq, kk, vv: verify_attention(
            qq, kk[period], vv[period], lens))(q, k, v)
        want = [verify_attention(q[i], k[i, period], v[i, period], lens)
                for i in range(r)]
    assert got.dtype == dtype and got.shape == (r, b, sq, hkv * g, d)
    assert torch.equal(got, torch.stack(want))


def test_vmap_rule_on_caches_it_cannot_fold_or_does_not_batch():
    """Nested ``vmap`` over a cache whose two batched axes no view
    merges (a transposed stack) is refused, not copied; nested over one
    that folds, it equals the loop; a cache shared by every replica is
    expanded, not copied."""
    r, s, b, length, hkv, d = 3, 2, 2, 20, 2, 16
    k = _randn(s, r, b, length, hkv, d, seed=5).transpose(0, 1)
    v = _randn(s, r, b, length, hkv, d, seed=6).transpose(0, 1)
    q = _randn(r, s, b, 1, hkv, d, seed=7)
    lens = _lengths((b, 1), length, 8)
    nested = torch.func.vmap(torch.func.vmap(
        lambda qq, kk, vv: verify_attention(qq, kk, vv, lens)))
    with pytest.raises(ValueError, match="do not fold"):
        nested(q, k, v)
    kc, vc = k.contiguous(), v.contiguous()
    want = torch.stack([torch.stack([
        verify_attention(q[i, j], kc[i, j], vc[i, j], lens)
        for j in range(s)]) for i in range(r)])
    assert torch.equal(nested(q, kc, vc), want)
    shared = torch.func.vmap(lambda qq: verify_attention(
        qq, k[0, 0], v[0, 0], lens))(q[:, 0])
    assert torch.equal(shared, torch.stack([
        verify_attention(q[i, 0], k[0, 0], v[0, 0], lens) for i in range(r)]))


def test_verify_at_one_query_is_decode_bit_for_bit():
    r, b, length, hkv, g, d = 3, 4, 37, 2, 2, 32
    k = _randn(r, b, length, hkv, d, seed=9)
    v = _randn(r, b, length, hkv, d, seed=10)
    q = _randn(r, b, 1, hkv * g, d, seed=11)
    valid = _lengths((b,), length, 12)
    for i in range(r):
        assert torch.equal(verify_attention(q[i], k[i], v[i], valid[:, None]),
                           decode_attention(q[i], k[i], v[i], valid))
    dec = torch.func.vmap(lambda qq, kk, vv: decode_attention(
        qq, kk, vv, valid))(q, k, v)
    ver = torch.func.vmap(lambda qq, kk, vv: verify_attention(
        qq, kk, vv, valid[:, None]))(q, k, v)
    assert torch.equal(dec, ver)
    whole = torch.full((b,), length, dtype=torch.int32)
    assert torch.equal(decode_attention(q[0], k[0], v[0]),
                       decode_attention(q[0], k[0], v[0], whole))


@pytest.mark.parametrize("sq", [1, 4])
def test_plain_path_is_the_einsum_body_on_the_lengths_mask(sq):
    b, length, hkv, g, d = 3, 29, 2, 3, 16
    k = _randn(b, length, hkv, d, seed=13)
    v = _randn(b, length, hkv, d, seed=14)
    q = _randn(b, sq, hkv * g, d, seed=15)
    lens = _lengths((b, sq), length, 16)
    mask = torch.arange(length)[None, None, :] < lens[:, :, None]
    assert torch.equal(verify_attention(q, k, v, lens),
                       _cached_attention(q, k, v, mask))
    assert torch.equal(verify_attention(q, k, v),
                       _cached_attention(q, k, v, None))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_gives_the_kernels_shape_and_counts_a_launch(dtype):
    r, b, length, hkv, g, sq, d = 7, 12, 2048, 20, 1, 1, 128
    k = torch.empty((r, 4, b, length, hkv, d), dtype=dtype, device="meta")
    q = torch.empty((r, b, sq, hkv * g, d), dtype=dtype, device="meta")
    lens = torch.empty((b,), dtype=torch.int32, device="meta")
    _build.reset_launches()
    out = decode_attention(q[0], k[0, 1], k[0, 2], lens)
    assert (out.shape, out.dtype, out.device.type) == (
        (b, sq, hkv * g, d), dtype, "meta")
    assert _build.LAUNCHES["decode_attention"] == 1
    out = torch.func.vmap(lambda qq, kk: decode_attention(
        qq, kk[3], kk[3], lens))(q, k)
    assert (out.shape, out.dtype) == ((r, b, sq, hkv * g, d), dtype)
    assert _build.LAUNCHES["decode_attention"] == 2
    assert sum(_build.LAUNCHES.values()) == 2
    _build.reset_launches()


def _attention_calls(cfg) -> int:
    """Cached-attention calls of one decode step: one per attention
    layer, two for an ``xattn`` layer (its cross-attention too)."""
    slots = [cfg.slot(i) for i in range(cfg.n_layers)]
    return sum((s != "mamba") + (s == "xattn") for s in slots)


@pytest.mark.parametrize("arch,layers", [
    ("qwen1_5_4b", 4), ("llama3_2_3b", 0), ("gemma3_1b", 0),
    ("jamba_1_5_large", 3), ("llama3_2_vision", 0)])
def test_dryrun_of_a_decode_step_traces_one_launch_per_attention_call(
        arch, layers):
    """The serving cell's shapes (qwen1.5-4b at its widths, 4 layers, 7
    replicas of 12 slots of 2,048 positions) and reduced configs with
    ring, Mamba and cross-attention slots, each on one rank."""
    cfg = (dataclasses.replace(get_config(arch), n_layers=layers)
           if arch == "qwen1_5_4b" else get_reduced(arch))
    if arch != "qwen1_5_4b" and layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    slots, cache_len = (12, 2048) if arch == "qwen1_5_4b" else (2, 32)
    pred = dryrun.trace_serve_step(
        cfg, AggSpec(f=1, gar="bulyan-krum", distance_backend="fused"),
        dryrun.RecordingMesh((1, 1)), 7, slots, cache_len,
        pos=np.full((slots,), cache_len - 1, np.int32))
    assert pred["launches"]["decode_attention"] == _attention_calls(cfg) > 0
    assert pred["launches"]["fused_aggregate"] == 3


def test_pieces_of_the_length_depend_on_it_alone():
    for length in (1, 255, 256, 257, 2048, 16384, 16385, 32768, 131072):
        split = da._split_len(length)
        pieces = -(-length // split)
        assert split % 256 == 0 and 1 <= pieces <= 64
        assert pieces == 1 or (pieces - 1) * split < length
    assert da._split_len(2048) == 256


def test_kernel_checks_refuse_what_it_does_not_take():
    def args(d=128, dtype=torch.float32, hq=4, lens=(2, 3, 1)):
        q = torch.zeros((2, 3, 1, hq, d), dtype=dtype)
        k = torch.zeros((2, 3, 16, 2, d), dtype=dtype)
        return q, k, k.clone(), torch.ones(lens, dtype=torch.int32)

    da._check(*args())
    da._check(*args(d=8, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        da._check(*args(dtype=torch.float16))
    q, k, v, lens = args()
    with pytest.raises(TypeError):
        da._check(q, k.to(torch.bfloat16), v, lens)
    with pytest.raises(ValueError):
        da._check(*args(d=96))
    with pytest.raises(ValueError):
        da._check(*args(hq=3))
    with pytest.raises(ValueError):
        da._check(*args(lens=(2, 3, 2)))
    with pytest.raises(ValueError):  # (L, Hkv, D) not dense
        wide = torch.zeros(k.shape[:4] + (256,))[..., :128]
        da._check(q, wide, wide, lens)
    with pytest.raises(ValueError):  # rows not 16-byte aligned
        off = torch.zeros(k.numel() + 1)[1:].view(k.shape)
        da._check(q, off, off, lens)
    with pytest.raises(ValueError):
        da._check(q[0], k[0], v[0], lens[0])
