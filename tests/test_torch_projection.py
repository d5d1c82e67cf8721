"""The column-invariant projection (``kernels/projection.py``) on the
CPU: its shape checks run before the device check (on ``meta``, where
no kernel exists), a CPU tensor takes ``torch.matmul`` bit for bit and
launches nothing, the autograd backward equals the plain products'
gradients, and the model reaches ``ops.projection`` for exactly the
leaves tensor parallelism splits by columns (``sharding/tp.py``'s
``_COL_PARALLEL``) in a forward and in decode steps of a dense, a vision
and an audio reduced config."""
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import projection as P
from repro_torch.models import transformer as T
from repro_torch.models.frontends import (
    synthetic_frames, synthetic_patches)
from repro_torch.models.params import _leaves, init_params
from repro_torch.sharding.tp import _COL_PARALLEL

META = dict(device="meta")


# ----------------------------------------------------------------------
# the wrapper's checks and the CPU path
# ----------------------------------------------------------------------
@pytest.mark.parametrize("x,w,err,match", [
    ((8, 16), (16, 24, "f32"), TypeError, "share a dtype"),
    ((8, 16), (32, 24), ValueError, "shapes"),
    ((8, 16), (16, 4, 6), ValueError, "shapes"),
    ((8, 16, "f16"), (16, 24, "f16"), TypeError, "float32 or bfloat16"),
])
def test_shape_checks_raise_before_the_device_check(x, w, err, match):
    def make(spec):
        dt = {"f32": torch.float32, "f16": torch.float16}.get(
            spec[-1], torch.bfloat16)
        dims = [d for d in spec if isinstance(d, int)]
        return torch.empty(dims, dtype=dt, **META)

    with pytest.raises(err, match=match):
        ops.projection(make(x), make(w))


@pytest.mark.parametrize("dtype,x,w", [
    (torch.bfloat16, (8, 16), (16, 24)),
    (torch.bfloat16, (2, 3, 64), (64, 256)),
    # a width off bf16's grid of 8 (whisper-medium's 51865-token
    # vocabulary) is padded for the kernel, not refused
    (torch.bfloat16, (8, 16), (16, 13)),
    (torch.bfloat16, (8, 12), (12, 24)),
    (torch.float32, (8, 12), (12, 36)),
])
def test_shapes_it_takes_reach_the_device_check(dtype, x, w):
    xt = torch.empty(x, dtype=dtype, **META)
    wt = torch.empty(w, dtype=dtype, **META)
    with pytest.raises(ValueError, match="no kernel"):
        ops.projection(xt, wt)
    with pytest.raises(ValueError, match="no kernel"):   # autograd route
        ops.projection(xt.requires_grad_(), wt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_matmul_bit_for_bit_without_launching(dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 5, 48)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(48, 40)).astype(np.float32))
    x, w = x.to(dtype), w.to(dtype)
    ops.reset_launch_counts()
    assert torch.equal(ops.projection(x, w), torch.matmul(x, w))
    assert ops.launch_counts()["projection"] == 0


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-6),
                                        (torch.bfloat16, 0.0)])
def test_autograd_backward_equals_the_plain_products_gradients(dtype,
                                                                atol):
    """``_Projection``'s backward (dx = dy w^T, dw = x^T dy) against
    autograd through ``torch.matmul``, on a 3-D x as the model passes
    it."""
    rng = np.random.default_rng(1)
    xn = rng.normal(size=(2, 7, 32)).astype(np.float32)
    wn = rng.normal(size=(32, 24)).astype(np.float32)
    rn = torch.from_numpy(rng.normal(size=(2, 7, 24)).astype(np.float32))
    grads = []
    for fn in (P._Projection.apply, torch.matmul):
        x = torch.from_numpy(xn).to(dtype).requires_grad_()
        w = torch.from_numpy(wn).to(dtype).requires_grad_()
        (fn(x, w).float() * rn).sum().backward()
        grads.append((x.grad, w.grad))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=atol)


# ----------------------------------------------------------------------
# the model reaches it for exactly the column-split leaves
# ----------------------------------------------------------------------
class Recorder:
    """Stands in for ``ops.projection``: records which param leaf each
    call's weight is (a stacked leaf's layer view counts as the leaf)
    and computes the plain product."""

    def __init__(self, params):
        self.spans = [(t.data_ptr(),
                       t.data_ptr() + t.numel() * t.element_size(), path)
                      for path, t in _leaves(params)]
        self.seen = []

    def leaf(self, w):
        for lo, hi, path in self.spans:
            if lo <= w.data_ptr() < hi:
                return path
        return None

    def __call__(self, x, w):
        self.seen.append(self.leaf(w))
        return P.projection_plain(x, w)

    def names(self):
        return {p.rsplit("/", 1)[-1] if p else None for p in self.seen}


def _model(arch):
    cfg = get_config(arch, reduced=True).replace(dtype="float32")
    return cfg, init_params(cfg, 0, device="cpu")


def _frontend(cfg, b):
    if cfg.frontend == "audio":
        return synthetic_frames(cfg, b, device="cpu")
    if cfg.frontend == "vision":
        return synthetic_patches(cfg, b, device="cpu")
    return None


ATTN = {"wq", "wk", "wv"}


@pytest.mark.parametrize("arch,forward_leaves,decode_leaves", [
    # dense: the MLP's w_gate / w_up go through kernel 3 on a forward
    # and through the projection on a decode step's blocked SwiGLU
    ("llama3-8b", ATTN | {"lm_head"}, ATTN | {"w_gate", "w_up", "lm_head"}),
    ("llava-next-mistral-7b", ATTN | {"lm_head"},
     ATTN | {"w_gate", "w_up", "lm_head"}),
    # audio: a GELU MLP (w_in, w_out) and the cross-attention's wq at
    # every decode step; its wk / wv project the encoder's output once
    ("whisper-medium", ATTN | {"lm_head"}, {"wq", "wk", "wv", "lm_head"}),
])
def test_model_projects_exactly_the_column_split_leaves(
        monkeypatch, arch, forward_leaves, decode_leaves):
    cfg, params = _model(arch)
    rec = Recorder(params)
    monkeypatch.setattr(ops, "projection", rec)
    rng = np.random.default_rng(2)
    b, s = 2, 16 if cfg.frontend != "vision" else cfg.num_patches + 4
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(b, s)))
    fe = _frontend(cfg, b)
    with one_torch_thread(), torch.no_grad():
        logits, _ = T.forward(cfg, params, tokens, fe)
        assert rec.names() == forward_leaves
        assert all(rec.seen) and rec.names() <= _COL_PARALLEL
        rec.seen.clear()
        lg, cache = T.prefill(cfg, params, tokens, fe, cache_len=s + 2)
        rec.seen.clear()
        want, _ = T.decode_step(cfg, params, cache, lg.argmax(-1), s)
        assert all(rec.seen) and rec.names() <= _COL_PARALLEL
        assert rec.names() == decode_leaves
        # the projection's plain version is every CPU path's matmul: the
        # same step without the recorder gives the same bits
        monkeypatch.undo()
        _, cache2 = T.prefill(cfg, params, tokens, fe, cache_len=s + 2)
        again, _ = T.decode_step(cfg, params, cache2, lg.argmax(-1), s)
    assert torch.equal(again, want) and torch.isfinite(logits).all()


def test_paged_decode_step_projects_exactly_the_column_split_leaves(
        monkeypatch):
    """A dense reduced config's paged decode step (the step loop's):
    wq, wk, wv, the blocked SwiGLU's w_gate and w_up, the untied
    lm_head."""
    cfg, params = _model("llama3-8b")
    rec = Recorder(params)
    monkeypatch.setattr(ops, "projection", rec)
    b, page, nb = 2, 8, 2
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    pages = {k: torch.zeros((cfg.num_layers, b * nb, page, kv, hd))
             for k in ("k", "v")}
    table = torch.arange(b * nb, dtype=torch.int32).reshape(b, nb)
    with one_torch_thread(), torch.no_grad():
        logits, _ = T.decode_step_paged(
            cfg, params, pages, table, torch.tensor([5, 7]),
            torch.tensor([3, 9]), cache_len=nb * page)
    assert torch.isfinite(logits).all()
    assert all(rec.seen)
    assert rec.names() == ATTN | {"w_gate", "w_up", "lm_head"}
    per_layer = [p for p in rec.seen if p != "lm_head"]
    assert len(per_layer) == 5 * cfg.num_layers
