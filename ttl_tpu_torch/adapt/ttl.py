"""The episodic adaptation steps, batched over test samples, and the
zero-shot step.

Counterpart of `make_ttl_adapt_fn`, `make_batched_ttl_fn`,
`make_fused_ttl_fn`, `make_tpt_adapt_fn`, `make_fused_tpt_fn`,
`make_fused_cocoop_fn` and `make_fused_zeroshot_fn` (with its center-view
encoder, which `adapt/bongard.py` shares) in
`ttl_tpu/adapt/ttl.py`. Where the JAX package
vmaps a per-sample program, the port batches: every trainable leaf carries
a leading sample axis S. For S samples of V views:

LoRA modes (`make_batched_ttl_fn`):
1. the frozen part runs once over all S*V views under `torch.no_grad()`:
   the vision prefix below the window (`--lora_encoder image`), or the whole
   vision tower (`--lora_encoder text`), whose features are then constant;
2. each update step runs the adapted part forward and backward with one
   adapter set per sample ([S, L, D, r] leaves): the vision window on the
   views, or the text tower over the EOT-truncated class prompts of every
   sample ([S*C, ctx', D]). The loss is DeYO's per sample, or with
   `deyo_selection=False` the TPT objective over the views chosen once, by
   the unadapted logits; AdamW applies elementwise over the stacked
   adapters; a sample whose DeYO loss kept no view (n_backward == 0) keeps
   its adapters and optimizer state, weight decay included;
3. the adapted part runs once more for each sample's clean view (view 0).

With `--filter_plpd 1` (DeYO's PLPD filter) each update step also runs the
whole vision tower, without gradient and with the current adapters, over a
counterfactual of every view: its patches shuffled (`aug_type` patch, the
default), its pixels shuffled (pixel) or a window mean-filled (occ). A view
is kept only where the softmax of its own top class falls by more than
`plpd_threshold` on its counterfactual. The permutations are host draws per
(seed, dataset index, step), `draw_plpd_perms`.

Prompt tuning (`make_tpt_adapt_fn`, `--lora_encoder prompt`): the image
features of all views are frozen; the context vectors (and the learned
class tokens, if any) are the trainable state, [S, n_ctx, d]; every step
differentiates the whole text tower, each layer checkpointed.

Every call starts from the same initial state and a fresh optimizer state:
that is the episodic reset. The number of updates is
`effective_update_steps` (tta_steps**2 on the DeYO path, tta_steps on the
TPT paths, as in the reference).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import TTLConfig, effective_update_steps, resolve_layer_range
from ..models.clip import (CLIPConfig, encode_image, l2_normalize,
                           text_features, text_features_from_embeddings,
                           vision_from_hidden, vision_prefix)
from ..models.prompts import PromptLearnerState, needed_ctx_len
from ..ops.augmix import check_aug_ops
from ..ops.entropy import deyo_loss, select_confident, tpt_loss
from ..ops.image import (Draws, preprocess_center, render_views,
                         resize_bilinear, sample_generator)
from ..ops.lora import lora_scale

# torch.optim.AdamW defaults, as the reference and the JAX package use them
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-2
# the host generator stream of the PLPD permutations (ops.image's view
# draws are stream 0 of the same (seed, index))
PLPD_STREAM = 1


class AdaptResult(NamedTuple):
    logits: torch.Tensor     # [S, C] adapted clean-view logits
    losses: torch.Tensor     # [S, steps] adaptation losses
    adapters: dict           # final per-sample adapters, [S, L, ...] leaves
    # [S, C] unadapted clean-view logits: prompt tuning always, the LoRA
    # steps with zero_shot_aux; else None
    zero_shot_logits: Optional[torch.Tensor] = None


def compute_dtype(cfg: TTLConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def check_supported(cfg: TTLConfig) -> None:
    """Raise NotImplementedError for what this port does not cover yet,
    naming the ROADMAP (Queue 1) item that brings it."""
    check_aug_ops(cfg.aug_ops)
    if cfg.mesh_shape is not None:
        raise NotImplementedError("--mesh_shape is not ported to "
                                  "ttl_tpu_torch yet (ROADMAP Queue 1, "
                                  "item 17)")


# ------------------------------------------------------ PLPD counterfactuals

def patch_shuffle(views: torch.Tensor, perm: torch.Tensor,
                  patch_len: int) -> torch.Tensor:
    """aug_type 'patch': square views [N, 3, H, H] resized to the largest
    multiple of patch_len (bilinear, antialiased), cut into patch_len x patch_len
    patches, patch i of view n taken from patch perm[n, i], and resized
    back. perm: [N, patch_len**2]."""
    n, c, h, w = views.shape
    hp = (h // patch_len) * patch_len
    p = hp // patch_len
    x = resize_bilinear(views, hp)
    x = x.reshape(n, c, patch_len, p, patch_len, p).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(n, patch_len * patch_len, c, p, p)
    x = x[torch.arange(n, device=x.device).unsqueeze(1), perm]
    x = x.reshape(n, patch_len, patch_len, c, p, p).permute(0, 3, 1, 4, 2, 5)
    return resize_bilinear(x.reshape(n, c, hp, hp), h)


def pixel_shuffle(views: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """aug_type 'pixel': views [S, V, 3, H, W], the pixels of sample s's
    views all moved by one permutation perm[s] of H*W."""
    s, v, c, h, w = views.shape
    index = perm.reshape(s, 1, 1, h * w).expand(s, v, c, h * w)
    return torch.gather(views.reshape(s, v, c, h * w), 3, index).reshape(
        views.shape)


def occlude(views: torch.Tensor, cfg: TTLConfig) -> torch.Tensor:
    """aug_type 'occ': a occlusion_size square at (row_start, column_start)
    filled with each view's per-channel mean. views [N, 3, H, W]."""
    mean = views.mean(dim=(2, 3), keepdim=True)
    h, w = views.shape[-2:]
    rows = torch.arange(h, device=views.device).unsqueeze(1)
    cols = torch.arange(w, device=views.device).unsqueeze(0)
    inside = ((rows >= cfg.row_start)
              & (rows < cfg.row_start + cfg.occlusion_size)
              & (cols >= cfg.column_start)
              & (cols < cfg.column_start + cfg.occlusion_size))
    return torch.where(inside, mean, views)


def plpd_counterfactual(cfg: TTLConfig) -> bool:
    """Whether the LoRA step runs PLPD's counterfactual forward: under
    --filter_plpd, with the DeYO objective, as the JAX step does."""
    return bool(cfg.filter_plpd) and cfg.deyo_selection \
        and cfg.lora_encoder != "prompt" and not cfg.cocoop


def draw_plpd_perms(cfg: TTLConfig, idx: int) -> Optional[torch.Tensor]:
    """The counterfactual's permutations for dataset index `idx`, one
    host generator per (seed, index, step): aug_type patch [steps, V,
    patch_len**2] (a permutation per view), pixel [steps, H*W] (one per
    step); None for occ, which draws nothing."""
    if cfg.aug_type not in ("patch", "pixel"):
        return None
    out = []
    for step in range(effective_update_steps(cfg)):
        g = sample_generator(cfg.seed, idx, PLPD_STREAM, step)
        if cfg.aug_type == "patch":
            out.append(torch.rand(cfg.batch_size, cfg.patch_len ** 2,
                                  generator=g).argsort(dim=-1))
        else:
            out.append(torch.randperm(cfg.resolution ** 2, generator=g))
    return torch.stack(out)


def _plpd(logits: torch.Tensor, logits_prime: torch.Tensor) -> torch.Tensor:
    """p[argmax p] - p'[argmax p] per view, in f32."""
    p = torch.softmax(logits.float(), dim=-1)
    pp = torch.softmax(logits_prime.float(), dim=-1)
    cls1 = p.argmax(dim=-1, keepdim=True)
    return (p.gather(-1, cls1) - pp.gather(-1, cls1))[..., 0]


def _adamw(params, grads, mu, nu, count, do, lr):
    """One optax.adamw step over stacked per-sample leaves (leading axis S),
    applied where `do` [S] is set; returns (params, mu, nu, count)."""
    b1, b2 = ADAMW_BETAS
    count_new = count + 1
    new_p, new_mu, new_nu = [], [], []
    for p, g, m, v in zip(params, grads, mu, nu):
        shape = (-1,) + (1,) * (p.dim() - 1)
        m_n = (1 - b1) * g + b1 * m
        v_n = (1 - b2) * g * g + b2 * v
        c = count_new.to(torch.float32).reshape(shape)
        m_hat = m_n / (1 - b1 ** c)
        v_hat = v_n / (1 - b2 ** c)
        u = m_hat / (torch.sqrt(v_hat) + ADAMW_EPS) + ADAMW_WEIGHT_DECAY * p
        d = do.reshape(shape)
        new_p.append(torch.where(d, p + (-lr) * u, p))
        new_mu.append(torch.where(d, m_n, m))
        new_nu.append(torch.where(d, v_n, v))
    return new_p, new_mu, new_nu, torch.where(do, count_new, count)


_LEAVES = (("q", "A"), ("q", "B"), ("v", "A"), ("v", "B"))


def _to_tree(leaves) -> dict:
    tree = {"q": {}, "v": {}}
    for (m, ab), t in zip(_LEAVES, leaves):
        tree[m][ab] = t
    return tree


def _selection_k(cfg: TTLConfig) -> int:
    """Views the TPT objective keeps. The floor of 1 departs from the
    reference, whose int(N*p) == 0 selects nothing and gives a NaN loss."""
    return max(int(cfg.batch_size * cfg.selection_p), 1)


def _classify(params, feats: torch.Tensor, text_cls: torch.Tensor,
              n_samples: int) -> torch.Tensor:
    """exp(logit_scale) * feats @ text_cls^T per sample: feats [S*V', P]
    normalized image features; text_cls [C, P], one classifier for every
    sample, or [S, C, P], one a sample (the text-side paths' class
    features, the Bongard prototypes) -> [S, V', C]."""
    x = torch.exp(params["logit_scale"]) * feats
    if text_cls.dim() == 2:
        return (x @ text_cls.T).reshape(n_samples, -1, text_cls.shape[0])
    return torch.matmul(x.unflatten(0, (n_samples, -1)),
                        text_cls.transpose(-1, -2))


def _class_logits(params, img: torch.Tensor, txt: torch.Tensor,
                  n_samples: int) -> torch.Tensor:
    """`_classify` with text features txt [S*C, P], normalized here: one
    class table a sample -> [S, V, C]."""
    return _classify(params, img,
                     l2_normalize(txt).unflatten(0, (n_samples, -1)),
                     n_samples)


def truncate_tokens(tokens) -> np.ndarray:
    """EOT-truncate a token table (exact; `needed_ctx_len`)."""
    tokens = np.asarray(tokens)
    return tokens[:, : needed_ctx_len(tokens)].astype(np.int64)


def make_batched_ttl_fn(clip_cfg: CLIPConfig, cfg: TTLConfig, *,
                        tokens=None, zero_shot_aux: bool = False):
    """Return f(params, text_cls, adapters0, views [S, V, 3, H, W],
    plpd_perm=None) -> AdaptResult for S samples adapted independently.
    `text_cls` is [C, P], or [S, C, P] for one classifier a sample (image
    mode only). `tokens` [C, 77] is the class-prompt table, needed (and
    `text_cls` ignored) with `--lora_encoder text`. `plpd_perm`
    [S, steps, ...] holds the PLPD permutations (`draw_plpd_perms`), needed
    under --filter_plpd with aug_type patch or pixel.

    With `zero_shot_aux` the result's `zero_shot_logits` are the clean
    view's logits without adapters, from the cached frozen state of view 0:
    one more single-view pass of the adapted part, without gradient. Without
    it they are None and nothing more runs."""
    check_supported(cfg)
    if cfg.lora_encoder == "prompt":
        raise ValueError("--lora_encoder prompt adapts no LoRA: use "
                         "make_tpt_adapt_fn")
    on_image = cfg.lora_encoder == "image"
    window = resolve_layer_range(cfg, clip_cfg)
    scale = lora_scale(cfg.rank, cfg.lora_alpha)
    cd = compute_dtype(cfg)
    steps = effective_update_steps(cfg)
    k_sel = _selection_k(cfg)
    vcfg = clip_cfg.vision
    plpd_on = plpd_counterfactual(cfg)
    if not on_image:
        if tokens is None:
            raise ValueError("--lora_encoder text needs the class-prompt "
                             "token table")
        tokens = torch.from_numpy(truncate_tokens(tokens))

    def text_side(params, leaves):
        """Text mode: the class features [S*C, P] of the current adapters
        (of none where `leaves` is None: then [C, P])."""
        return text_features(params["text"], tokens.to(
            params["logit_scale"].device), clip_cfg.text,
            adapters=None if leaves is None else _to_tree(leaves),
            adapter_window=window, lora_scale=scale, compute_dtype=cd)

    def logits_for(params, text_cls, leaves, frozen, n_samples, txt=None):
        """[S, V', C] logits of the current adapters. `frozen` is the
        per-view state the adapters do not reach: the prefix hidden state
        [S*V', S_pad, D] (image mode), or the normalized image features
        [S*V', P] (text mode, whose class features `txt` may be given)."""
        if on_image:
            vf = vision_from_hidden(params["vision"], frozen, vcfg,
                                    adapters=_to_tree(leaves),
                                    adapter_window=window, lora_scale=scale)
            return _classify(params, l2_normalize(vf), text_cls, n_samples)
        if txt is None:
            txt = text_side(params, leaves)
        return _class_logits(params, frozen, txt, n_samples)

    def frozen_state(params, views):
        """The per-view state the adapters do not reach, views [S, V, ...]
        flattened: the prefix hidden state (image mode) or the normalized
        image features (text mode)."""
        if on_image:
            return vision_prefix(params["vision"], views.flatten(0, 1), vcfg,
                                 upto=window[0], compute_dtype=cd)
        return l2_normalize(encode_image(params["vision"], views.flatten(0, 1),
                                         vcfg, compute_dtype=cd))

    def counterfactual(views, perm):
        """PLPD's counterfactual of every view, [S*V, 3, H, W]."""
        if cfg.aug_type == "patch":
            return patch_shuffle(views.flatten(0, 1), perm.flatten(0, 1),
                                 cfg.patch_len)
        if cfg.aug_type == "pixel":
            return pixel_shuffle(views, perm).flatten(0, 1)
        return occlude(views.flatten(0, 1), cfg)

    def plpd_for(params, text_cls, leaves, views, perm, logits, txt):
        """The PLPD of every view [S, V]: the whole vision tower over the
        counterfactuals with the current adapters, without gradient."""
        with torch.no_grad():
            x_prime = counterfactual(views, perm)
            leaves = [t.detach() for t in leaves]
            frozen = frozen_state(params, x_prime.unflatten(0, views.shape[:2]))
            logits_prime = logits_for(
                params, text_cls, leaves, frozen, views.shape[0],
                None if txt is None else txt.detach())
        return _plpd(logits.detach(), logits_prime)

    def zero_shot(params, text_cls, frozen, s, v):
        """The clean views' logits without adapters, [S, C]."""
        with torch.no_grad():
            clean = frozen.unflatten(0, (s, v))[:, 0]
            if on_image:
                vf = vision_from_hidden(params["vision"], clean, vcfg,
                                        adapter_window=window)
                return _classify(params, l2_normalize(vf), text_cls, s)[:, 0]
            txt = l2_normalize(text_side(params, None))
            return _classify(params, clean, txt, s)[:, 0]

    def step(params, text_cls, adapters0, views,
             plpd_perm=None) -> AdaptResult:
        s, v = views.shape[:2]
        if not on_image and text_cls is not None and text_cls.dim() == 3:
            raise ValueError("a classifier per sample ([S, C, P] text_cls) "
                             "needs --lora_encoder image: text mode encodes "
                             "the class prompts itself")
        if plpd_on and plpd_perm is None and cfg.aug_type in ("patch",
                                                              "pixel"):
            raise ValueError("--filter_plpd with aug_type "
                             f"{cfg.aug_type!r} needs the step's plpd_perm "
                             "draws (draw_plpd_perms)")
        with torch.no_grad():
            frozen = frozen_state(params, views)
        leaves = [adapters0[m][ab].expand(s, *adapters0[m][ab].shape)
                  .clone() for m, ab in _LEAVES]
        every = torch.ones(s, dtype=torch.bool, device=views.device)
        sel_mask = None
        if not cfg.deyo_selection:
            # TPT on LoRA: the views are chosen once, by the unadapted logits
            with torch.no_grad():
                sel_mask = select_confident(
                    logits_for(params, text_cls, leaves, frozen, s), k_sel)[2]
        mu = [torch.zeros_like(t) for t in leaves]
        nu = [torch.zeros_like(t) for t in leaves]
        count = torch.zeros(s, dtype=torch.int32, device=views.device)
        losses = []
        for i in range(steps):
            with torch.enable_grad():
                leaves = [t.requires_grad_(True) for t in leaves]
                txt = None if on_image else text_side(params, leaves)
                logits = logits_for(params, text_cls, leaves, frozen, s, txt)
                if cfg.deyo_selection:
                    plpd = None if not plpd_on else plpd_for(
                        params, text_cls, leaves, views,
                        None if plpd_perm is None else plpd_perm[:, i],
                        logits, txt)
                    loss, aux = deyo_loss(
                        logits, margin_e0=cfg.deyo_margin_e0,
                        deyo_margin=cfg.deyo_margin,
                        filter_ent=bool(cfg.filter_ent),
                        selection_p=cfg.selection_p,
                        reweight_ent=float(cfg.reweight_ent), plpd=plpd,
                        filter_plpd=plpd_on,
                        plpd_threshold=cfg.plpd_threshold,
                        reweight_plpd=float(cfg.reweight_plpd))
                    do = aux["n_backward"] > 0
                else:
                    loss, do = tpt_loss(logits, sel_mask), every
                grads = torch.autograd.grad(loss.sum(), leaves)
            with torch.no_grad():
                leaves, mu, nu, count = _adamw(
                    [t.detach() for t in leaves], grads, mu, nu, count, do,
                    cfg.lr)
            losses.append(loss.detach())
        with torch.no_grad():
            clean = frozen.unflatten(0, (s, v))[:, 0]
            out = logits_for(params, text_cls, leaves, clean, s)[:, 0]
        return AdaptResult(
            logits=out, losses=torch.stack(losses, dim=1),
            adapters=_to_tree(leaves),
            zero_shot_logits=(zero_shot(params, text_cls, frozen, s, v)
                              if zero_shot_aux else None))

    return step


def make_fused_ttl_fn(clip_cfg: CLIPConfig, cfg: TTLConfig, *, tokens=None,
                      zero_shot_aux: bool = False):
    """View rendering + the batched step: f(params, text_cls, adapters0,
    canvases [S, C, C, 3] uint8, hs [S], ws [S], draws) -> AdaptResult.
    `draws` are the host-made random draws (`runner.sample_draws`: the
    views' of ops.image.draw_batch, and under --filter_plpd `plpd_perm`).
    `zero_shot_aux` as in `make_batched_ttl_fn`."""
    batched = make_batched_ttl_fn(clip_cfg, cfg, tokens=tokens,
                                  zero_shot_aux=zero_shot_aux)
    cd = compute_dtype(cfg)

    def fused(params, text_cls, adapters0, canvases, hs, ws,
              draws: Draws) -> AdaptResult:
        with torch.no_grad():
            views = render_views(canvases, hs, ws, draws,
                                 out_size=cfg.resolution, out_dtype=cd,
                                 aug_ops=cfg.aug_ops)
        return batched(params, text_cls, adapters0, views,
                       draws.get("plpd_perm"))

    return fused


def make_center_encoder(clip_cfg: CLIPConfig, cfg: TTLConfig):
    """f(params, canvases [N, C, C, 3] uint8, hs [N], ws [N]) -> [N, P]
    L2-normalized frozen features of the deterministic center view."""
    cd = compute_dtype(cfg)

    @torch.no_grad()
    def encode(params, canvases, hs, ws) -> torch.Tensor:
        views = preprocess_center(canvases, hs, ws, cfg.resolution,
                                  out_dtype=cd)
        return l2_normalize(encode_image(params["vision"], views,
                                         clip_cfg.vision, compute_dtype=cd))

    return encode


def make_fused_zeroshot_fn(clip_cfg: CLIPConfig, cfg: TTLConfig):
    """Center view + zero-shot classification (tta_steps 0):
    f(params, text_cls [C, P], canvases [S, C, C, 3] uint8, hs [S], ws [S])
    -> logits [S, C]. It consumes no randomness."""
    encode = make_center_encoder(clip_cfg, cfg)

    @torch.no_grad()
    def zeroshot(params, text_cls, canvases, hs, ws) -> torch.Tensor:
        vf = encode(params, canvases, hs, ws)
        return torch.exp(params["logit_scale"]) * vf @ text_cls.T

    return zeroshot


# ------------------------------------------------------------ prompt tuning

def make_tpt_adapt_fn(clip_cfg: CLIPConfig, cfg: TTLConfig):
    """TPT: tune the prompt learner's context vectors (and its learned class
    tokens, if it has them) instead of LoRA. Returns f(params, pl_state,
    views [S, V, 3, H, W]) -> (AdaptResult, adapted ctx [S, n_ctx, d]);
    `zero_shot_logits` are the unadapted clean-view logits."""
    check_supported(cfg)
    cd = compute_dtype(cfg)
    steps = cfg.tta_steps
    k_sel = _selection_k(cfg)

    def adapt(params, pl_state: PromptLearnerState, views):
        s = views.shape[0]
        with torch.no_grad():
            img = l2_normalize(encode_image(
                params["vision"], views.flatten(0, 1), clip_cfg.vision,
                compute_dtype=cd))
        learn_cls = pl_state.cls is not None

        def logits_for(leaves):
            embs = pl_state.assemble(leaves[0],
                                     leaves[1] if learn_cls else None)
            txt = text_features_from_embeddings(
                params["text"], embs.flatten(0, 1), pl_state.tokenized,
                clip_cfg.text, compute_dtype=cd, remat=True)
            return _class_logits(params, img, txt, s)

        init = [pl_state.ctx_init] + ([pl_state.cls_init] if learn_cls
                                      else [])
        leaves = [t.float().expand(s, *t.shape).clone() for t in init]
        # one unadapted forward gives the zero-shot logits and the selection
        with torch.no_grad():
            logits0 = logits_for(leaves)
            sel_mask = select_confident(logits0, k_sel)[2]
        mu = [torch.zeros_like(t) for t in leaves]
        nu = [torch.zeros_like(t) for t in leaves]
        count = torch.zeros(s, dtype=torch.int32, device=views.device)
        every = torch.ones(s, dtype=torch.bool, device=views.device)
        losses = []
        for _ in range(steps):
            with torch.enable_grad():
                leaves = [t.requires_grad_(True) for t in leaves]
                loss = tpt_loss(logits_for(leaves), sel_mask)
                grads = torch.autograd.grad(loss.sum(), leaves)
            with torch.no_grad():
                leaves, mu, nu, count = _adamw(
                    [t.detach() for t in leaves], grads, mu, nu, count,
                    every, cfg.lr)
            losses.append(loss.detach())
        with torch.no_grad():
            out = logits_for(leaves)[:, 0]
        losses = (torch.stack(losses, dim=1) if losses
                  else torch.zeros(s, 0, device=views.device))
        return AdaptResult(logits=out, losses=losses, adapters={},
                           zero_shot_logits=logits0[:, 0]), leaves[0]

    return adapt


def make_fused_tpt_fn(clip_cfg: CLIPConfig, cfg: TTLConfig):
    """View rendering + prompt tuning: f(params, pl_state, canvases, hs, ws,
    draws) -> (AdaptResult, adapted ctx [S, n_ctx, d])."""
    adapt = make_tpt_adapt_fn(clip_cfg, cfg)
    cd = compute_dtype(cfg)

    def fused(params, pl_state, canvases, hs, ws, draws: Draws):
        with torch.no_grad():
            views = render_views(canvases, hs, ws, draws,
                                 out_size=cfg.resolution, out_dtype=cd,
                                 aug_ops=cfg.aug_ops)
        return adapt(params, pl_state, views)

    return fused


def make_fused_cocoop_fn(clip_cfg: CLIPConfig, cfg: TTLConfig):
    """View rendering + CoCoOp ctx adaptation (`--cocoop`): f(params,
    co_state, canvases, hs, ws, draws) -> CoCoOpResult with a leading
    sample axis."""
    from .cocoop import make_cocoop_adapt_fn
    check_supported(cfg)
    adapt = make_cocoop_adapt_fn(clip_cfg, cfg)
    cd = compute_dtype(cfg)

    def fused(params, co_state, canvases, hs, ws, draws: Draws):
        with torch.no_grad():
            views = render_views(canvases, hs, ws, draws,
                                 out_size=cfg.resolution, out_dtype=cd,
                                 aug_ops=cfg.aug_ops)
        return adapt(params, co_state, views)

    return fused
