"""Int8 quantisation of the frozen vision prefix (`--prefix_quant int8`).

Counterpart of `ttl_tpu/ops/quant.py`. Weights are quantised once per
output channel (scale_j = max_i |w_ij| / 127, int8 codes), activations
dynamically per row, and the product runs int8 x int8 -> int32 with the f32
epilogue y = acc * (row_scale * col_scale) + b, cast back to x's dtype.

`linear_q` dispatches on the device of x. A CPU tensor takes
`linear_q_plain`, which follows the JAX `linear_q` step by step. A CUDA
tensor goes to K5, the hand-written int8 kernel in `csrc/quant_matmul.cu`,
which equals `linear_q_plain` bit for bit; anything it does not take
raises. K5 is three launches into scratch the wrapper allocates: (Q) one
pass per row of x that writes its scale and its int8 codes, K padded with
zero codes to the product's 128-byte K step; (W) the int8 weight copied to
K-major order [N, Kp]; (G) the product on the tensor cores (`mma.sync`
m16n8k32 int8 fed by a `cp.async` ring) with the epilogue fused.
`linear_q.launches` grows by one at each call of K5, whatever its launches.
Against the bf16 `linear` it stands in for, on an H100 at the main path's
shapes (`PERF.md`): faster at K = 768 (q, k, v, o and fc1), slower at fc2
(K = 3072), where (Q) alone reads and writes about 1 GB.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import _build

Params = Dict[str, Any]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
LINEARS = {"attn": ("q", "k", "v", "o"), "mlp": ("fc1", "fc2")}


def quantize_linear(p: Params) -> Params:
    """Quantise one linear (or a stacked [L, in, out] layer of them) to
    symmetric per-output-channel int8; the bias stays f32."""
    w = p["w"].float()
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # multiplication by its reciprocal, which is not JAX's f32 division
    d127 = torch.full((), 127.0, device=w.device)
    scale = torch.clamp_min(w.abs().amax(dim=-2) / d127, 1e-12)
    out = {"wq": torch.round(w / scale.unsqueeze(-2)).to(torch.int8),
           "scale": scale}
    if "b" in p:
        out["b"] = p["b"].float()
    return out


def _row_scale(x: torch.Tensor) -> torch.Tensor:
    """max(absmax(x), 1e-12) * (1 / 127), every step in x's dtype."""
    inv127 = torch.ones((), dtype=x.dtype, device=x.device) / 127
    tiny = torch.full((), 1e-12, dtype=x.dtype, device=x.device)
    return torch.maximum(x.abs().amax(dim=-1, keepdim=True), tiny) * inv127


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """a * b + c for f32 tensors, rounded once to f32 (IEEE fma). The
    product of two f32 values is exact in f64; the f64 sum is rounded to
    odd (its exact error, from TwoSum, moves an even result one ulp toward
    the true value), and one rounding of a round-to-odd f64 to f32 is the
    correctly rounded result, since 53 >= 24 + 2."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    p_part = s - c
    c_part = s - p_part
    err = (p - p_part) + (c - c_part)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where(inexact_even, torch.nextafter(s, toward), s).float()


def linear_q_plain(x: torch.Tensor, pq: Params) -> torch.Tensor:
    """Plain PyTorch version of K5, with `ttl_tpu.ops.quant.linear_q`'s
    numerics: the row scale and x / s in x's dtype, codes rounded half to
    even and clipped to +-127, the int32 accumulator (as an f64 matmul of
    the codes, exact since |acc| <= K * 127^2 < 2^53, then rounded to f32),
    and the f32 epilogue acc * (s * col_scale) + b with the bias added in
    one fused multiply-add, as XLA compiles `linear_q`."""
    s = _row_scale(x)
    xq = torch.clamp(torch.round((x / s).float()), -127.0, 127.0)
    acc = torch.matmul(xq.double(), pq["wq"].double()).float()
    step = s.float() * pq["scale"]
    y = fma_f32(acc, step, pq["b"]) if "b" in pq else acc * step
    return y.to(x.dtype)


def quantized_matmul_cuda(x: torch.Tensor, wq: torch.Tensor,
                          scale: torch.Tensor, b: torch.Tensor
                          ) -> torch.Tensor:
    """Run K5 on the current stream: x [T, K] bf16/f32, wq [K, N] int8,
    scale and b [N] f32 -> [T, N] in x's dtype. The scratch (x's codes and
    row scales, wq in K-major order) is allocated here, once per call."""
    if x.dim() != 2 or wq.dim() != 2:
        raise ValueError(f"expected x [T, K] and wq [K, N], got "
                         f"{tuple(x.shape)} and {tuple(wq.shape)}")
    t, k = x.shape
    n = wq.shape[1]
    for name, a, dtypes in (("x", x, tuple(_DTYPE_CODES)),
                            ("wq", wq, (torch.int8,)),
                            ("scale", scale, (torch.float32,)),
                            ("b", b, (torch.float32,))):
        if a.device.type != "cuda" or a.device != x.device:
            raise ValueError(f"K5 takes CUDA tensors on one device; {name} "
                             f"is on {a.device}")
        if a.dtype not in dtypes:
            raise ValueError(f"K5: {name} must be one of {dtypes}, got "
                             f"{a.dtype}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"K5: {name} must be contiguous and start at a "
                             "16-byte boundary")
    if wq.shape[0] != k or scale.shape != (n,) or b.shape != (n,):
        raise ValueError(f"K5 shapes: x {tuple(x.shape)}, wq "
                         f"{tuple(wq.shape)}, scale {tuple(scale.shape)}, b "
                         f"{tuple(b.shape)}")
    if k % 16 or n % 16 or t == 0:
        raise ValueError(f"K5 takes K and N multiples of 16 and T > 0, got "
                         f"T={t}, K={k}, N={n}")
    lib = _build.library()
    y = torch.empty(t, n, dtype=x.dtype, device=x.device)
    scratch = torch.empty(lib.ttl_quant_matmul_scratch_bytes(t, k, n),
                          dtype=torch.uint8, device=x.device)
    rc = lib.ttl_quant_matmul(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), b.data_ptr(),
        y.data_ptr(), scratch.data_ptr(), scratch.numel(),
        _DTYPE_CODES[x.dtype], t, k, n,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, f"int8 matmul at T={t}, K={k}, N={n}, {x.dtype}")
    linear_q.launches += 1
    return y


def linear_q(x: torch.Tensor, pq: Params) -> torch.Tensor:
    """y = x @ dequant(wq) + b through the int8 product, x [..., K]. CPU
    tensors take the plain version, CUDA tensors K5."""
    if x.device.type == "cpu":
        return linear_q_plain(x, pq)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 linear for device {x.device}")
    b = pq.get("b")
    if b is None:
        b = torch.zeros_like(pq["scale"])
    y = quantized_matmul_cuda(x.reshape(-1, x.shape[-1]), pq["wq"],
                              pq["scale"], b)
    return y.reshape(*x.shape[:-1], y.shape[-1])


linear_q.launches = 0


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def quantize_layer_stack(stacked: Params, upto: int) -> Params:
    """Quantise the first `upto` stacked transformer layers: the six linears
    go int8, the layernorm affines stay f32. Only the unfused attention
    layout is taken."""
    if "qkv" in stacked["attn"]:
        raise ValueError("prefix quantization does not compose with "
                         "fuse_qkv_params; quantize the unfused layout")

    sl = _tree_map(lambda a: a[:upto], stacked)
    out = {ln: _tree_map(lambda a: a.float(), sl[ln]) for ln in ("ln1", "ln2")}
    for group, names in LINEARS.items():
        out[group] = {name: quantize_linear(sl[group][name])
                      for name in names}
    return out


def attach_prefix_quant(params: Params, upto: int, *,
                        drop_fp: bool = False) -> Params:
    """Return params whose vision tower carries an int8 copy of its first
    `upto` layers under 'prefix_q' (read by `models.clip.vision_prefix`).
    With `drop_fp`, and only when the whole tower is quantised, the fp layer
    stack becomes zero-length slices: nothing reads it again."""
    vision = params["vision"]
    if "layers" not in vision or "patch_embed" not in vision:
        return params
    if upto <= 0 or "prefix_q" in vision:
        return params
    n_layers = vision["layers"]["ln1"]["scale"].shape[0]
    vision = dict(vision)
    vision["prefix_q"] = quantize_layer_stack(vision["layers"],
                                              min(upto, n_layers))
    if drop_fp and upto >= n_layers:
        vision["layers"] = _tree_map(lambda a: a[:0], vision["layers"])
    out = dict(params)
    out["vision"] = vision
    return out


def quant_prefix_len(cfg, clip_cfg) -> int:
    """How many vision layers a config may quantise: those below the LoRA
    window when the image encoder is adapted, else the whole tower. A ViT
    tower without int8 layers (`ViTTower.int8`) raises."""
    from ..config import resolve_layer_range
    from ..models.clip import TOWERS, VisionConfig
    if not isinstance(clip_cfg.vision, VisionConfig):
        return 0
    if not TOWERS[clip_cfg.vision.tower].int8:
        raise ValueError("the int8 prefix (--prefix_quant int8) is not "
                         f"supported on the {clip_cfg.vision.tower.upper()} "
                         "vision tower")
    image_adapted = (cfg.lora_encoder == "image" and cfg.tta_steps > 0
                     and not cfg.cocoop)
    return (resolve_layer_range(cfg, clip_cfg)[0] if image_adapted
            else clip_cfg.vision.layers)
