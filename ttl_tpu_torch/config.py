"""Typed configuration of the port: the port's own copy of
`ttl_tpu/config.py`, field for field.

Field names and defaults mirror the reference CLI (reference: ttl.py:366-424)
so that an invocation of the reference's `ttl.py` maps 1:1 onto `TTLConfig`.
The reference threads a raw argparse namespace through every layer; here the
same surface is a frozen dataclass that every layer can close over
(static hashable config).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TTLConfig:
    # --- data / datasets (reference: ttl.py:383-389)
    data: str = "datasets"                # dataset root dir
    test_sets: str = "A"                  # slash-separated set ids, e.g. "A/V/R/K"
    dataset_mode: str = "test"            # train/val/test split for CoOp datasets
    arch: str = "ViT-B/16"
    resolution: int = 224
    workers: int = 4
    batch_size: int = 64                  # total views per test sample (1 clean + bs-1 aug)
    images_per_class: Optional[int] = None

    # --- optimization (reference: ttl.py:390-395)
    lr: float = 5e-3
    print_freq: int = 10
    gpu: int = 0                          # CUDA device index of the run      
    tpt: bool = True                      # multi-view augmentation pipeline on
    selection_p: float = 0.1              # confident-view fraction (TPT path)
    tta_steps: int = 1

    # --- prompt machinery (reference: ttl.py:396-399)
    n_ctx: int = 4
    ctx_init: str = "a_photo_of_a"
    cocoop: bool = False
    load: Optional[str] = None

    seed: int = 0

    # 80-template ensemble text classifier (the reference's MyClip
    # zeroshot_classifier, custom_clip_old.py:534-630, and the README's
    # "Ensemble (80 prompts)" baseline row): per class, mean of the
    # normalized per-template embeddings, re-normalized. Replaces the
    # single-template classifier wherever the text tower is frozen
    ensemble: bool = False

    # --- LoRA (reference: ttl.py:402-405)
    # Inclusive trainable/reset layer window. None (default) = arch-relative:
    # the last 3 layers of the tower actually being adapted, resolved by
    # `resolve_layer_range` -> (9, 11) on every 12-layer tower (identical to
    # the reference's hard-coded default, ttl.py:372) and (21, 23) on
    # ViT-L/14's 24-layer vision tower. The reference's literal "9,11" is
    # "the last 3" only on 12-layer towers; applied to a 24-layer tower it
    # lands mid-tower and forces 12 differentiated suffix layers (multi-x
    # slower for no accuracy reason). --layer_range remains the
    # explicit override.
    layer_range: Optional[Tuple[int, int]] = None
    init_method: Optional[str] = "xavier"    # xavier|gaussian|kaiming|pretrained|None
    lora_encoder: str = "image"              # image|text|prompt
    rank: int = 16
    lora_alpha: int = 32                     # fixed 32 in reference (custom_clip.py:585)

    # --- DeYO objective (reference: ttl.py:408-424)
    deyo_selection: bool = True
    aug_type: str = "patch"                  # patch|pixel|occ (PLPD counterfactual)
    occlusion_size: int = 112
    patch_len: int = 6
    row_start: int = 56
    column_start: int = 56
    deyo_margin: float = 0.5                 # entropy filter threshold (passed UNSCALED,
    deyo_margin_e0: float = 0.4              # reweight margin Ent_0      see ttl.py:80)
    plpd_threshold: float = 0.2
    fishers: int = 0
    filter_ent: int = 0                      # default OFF: keep-all filter ent<=log(1000)
    filter_plpd: int = 0                     # default OFF: no counterfactual pass
    reweight_ent: int = 1                    # default ON: coeff = exp(-(ent - e0))
    reweight_plpd: int = 0                   # coeff term commented out upstream
                                             # (deyo.py:175-177): participates in
                                             # the reweight on/off decision only

    # --- AugMix view chains (reference: data/datautils.py:110-138).
    # The reference ships with aug_list=[] in both branches (the
    # `augmentations.augmentations` import is commented out), so the default
    # view is crop+flip only; a non-empty tuple of op names from
    # the JAX package's ops.augmix.AUG_OPS enables the 3-chain Dirichlet/Beta AugMix
    # mixing over those ops, matching augmix(x, preprocess, aug_list, severity)
    aug_ops: Tuple[str, ...] = ()
    aug_severity: int = 1                    # datautils.py:126 severity=1

    # --- extensions (no reference equivalent)
    # samples adapted concurrently (one batched step). Per-sample results
    # are identical for any value (episodic adaptation is independent by
    # construction)
    sample_batch: int = 8
    # device steps kept in flight by the eval loop, so the host reads older
    # counts while newer steps run. Results are identical at any depth - it
    # only changes dispatch/fetch overlap
    pipeline_depth: int = 2
    # host->device canvas edge (uint8 [S, canvas, canvas, 3] per step).
    # 0 = auto: a dataset that declares `max_image_dim` (in-memory arrays,
    # CIFAR-10) gets a canvas that exactly fits; others use 512. Small-image
    # datasets (e.g. EuroSAT's 64px) can set --canvas 64 explicitly to cut
    # the per-step host->device transfer up to 64x - results are identical
    # whenever no image exceeds the canvas (crops read only the image area;
    # oversized images are downscaled to fit, as at any canvas size)
    canvas: int = 0
    mesh_shape: Optional[Tuple[int, ...]] = None  # data-parallel mesh, None = all chips
    param_dtype: str = "bfloat16"            # frozen tower weights
    compute_dtype: str = "bfloat16"          # activations (entropy math stays fp32)
    augment_on_device: bool = True           # device view pipeline vs host PIL-equivalent
    checkpoint_path: Optional[str] = None    # local CLIP weights (HF or OpenAI layout)
    # int8-quantize the frozen vision layers the gradient never touches
    # (below the LoRA window in image mode; the whole tower when it is
    # frozen), see ops/quant.py; default off - full precision is the
    # accuracy-parity configuration
    prefix_quant: str = "none"               # none|int8
    # write the end-of-run summary (per-set top1/top5 + the exact config)
    # as machine-readable JSON alongside the printed table (the reference
    # only prints, ttl.py:288-297); None = don't write
    results_json: Optional[str] = None

    @property
    def n_views(self) -> int:
        return self.batch_size

    @property
    def selection_k(self) -> int:
        """Static top-k for confident-view selection: int(64 * 0.1) = 6."""
        return int(self.batch_size * self.selection_p)

    @property
    def deyo_keep_threshold(self) -> float:
        """The default keep-filter bound used when filter_ent=0 (deyo.py:107)."""
        return math.log(1000.0)

    def replace(self, **kw) -> "TTLConfig":
        return dataclasses.replace(self, **kw)


def resolve_layer_range(cfg: TTLConfig, clip_cfg) -> Tuple[int, int]:
    """The concrete (lo, hi) adapter window for a config + architecture.

    An explicit `layer_range` (CLI `--layer_range lo,hi`) is returned as-is.
    The None default resolves arch-relative to the LAST 3 layers of the
    adapted tower - the reference's *intent* ("train the last few layers",
    ttl.py:372 + custom_clip.py:596-616), which its hard-coded (9, 11) only
    realizes on 12-layer towers:

      lora_encoder='image': vision tower -> (9, 11) ViT-B/*, (21, 23) ViT-L
      lora_encoder='text' / 'prompt':  text tower -> (9, 11) (12 layers in
      every published CLIP text config)

    For ResNet vision towers (no transformer layers to adapt; LoRA is
    ViT-only as in the reference) the text tower's depth is used so prompt/
    text modes still resolve; image-mode adaptation on ResNet is rejected
    elsewhere (runner.make_adapters0 / evaluate_dataset).
    """
    if cfg.layer_range is not None:
        return tuple(cfg.layer_range)
    n = None
    if cfg.lora_encoder == "image":
        n = getattr(clip_cfg.vision, "layers", None)
    if not isinstance(n, int):  # text/prompt modes, or a ResNet block tuple
        n = clip_cfg.text.layers
    return (max(n - 3, 0), n - 1)


def effective_update_steps(cfg: TTLConfig) -> int:
    """Number of optimizer steps one test sample receives.

    Faithfulness quirk: the reference constructs a fresh DeYO wrapper *inside*
    its `for j in range(tta_steps)` loop, and DeYO itself loops `steps=tta_steps`
    times (ttl.py:78-81, deyo.py:42-46), so the DeYO path performs tta_steps**2
    updates; the TPT path performs tta_steps.
    """
    if cfg.deyo_selection and cfg.lora_encoder != "prompt":
        return cfg.tta_steps * cfg.tta_steps
    return cfg.tta_steps
