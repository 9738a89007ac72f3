"""The steps tests/test_torch_tensor_parallel.py runs over a model axis and
in one process.

`run_cases(tmp, mesh)` builds every adaptation mode's step, and the runner
(`runner.run` over four samples, on mesh (1, 2) with a mesh), from the inputs
the test writes into `tmp` (JAX's weights and adapters as .npz, the views,
canvases and classifiers as data.npz), with `mesh` (a rank of a model axis:
its weights split by `shard_params`) or without (one process, whole
weights), runs each once and returns its results as lists, with the
gradient each LoRA step hands AdamW at its first update. It imports the
port only: the ranks run it in processes of their own.
"""
import numpy as np
import torch

from ttl_tpu_torch import runner
from ttl_tpu_torch.adapt import ttl
from ttl_tpu_torch.adapt.cocoop import init_cocoop
from ttl_tpu_torch.adapt.ttl import (make_batched_ttl_fn,
                                     make_fused_cocoop_fn, make_fused_tpt_fn,
                                     make_fused_ttl_fn,
                                     make_fused_zeroshot_fn)
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.data.views import ArrayDataset
from ttl_tpu_torch.models.clip import encode_image, fuse_qkv_params
from ttl_tpu_torch.models.convert import (adapters_from_numpy, load_pytree,
                                          params_from_numpy)
from ttl_tpu_torch.models.prompts import init_prompt_learner
from ttl_tpu_torch.models.zoo import TEST_TINY
from ttl_tpu_torch.ops.quant import attach_prefix_quant
from ttl_tpu_torch.parallel import tensor as tp
from ttl_tpu_torch.parallel.eval import make_sharded_ttl_fn
from ttl_tpu_torch.parallel.mesh import shard_params

CFG_KW = dict(arch="test-tiny", resolution=64, batch_size=8,
              layer_range=(2, 3), rank=4, compute_dtype="float32",
              param_dtype="float32")
CLASSES = ["forest", "river", "highway", "pasture", "lake", "sea"]


def first_gradients():
    """Wrap the steps' AdamW: a list that holds the first update's
    gradients, concatenated, once a step has run."""
    adamw, seen = ttl._adamw, []

    def recording(params, grads, *rest):
        if not seen:
            seen.append(torch.cat([g.detach().flatten() for g in grads]))
        return adamw(params, grads, *rest)
    ttl._adamw = recording
    return seen, adamw


def run_cases(tmp, mesh=None) -> dict:
    data = np.load(f"{tmp}/data.npz")
    whole = params_from_numpy(load_pytree(f"{tmp}/params.npz"), "cpu")
    adapters0 = adapters_from_numpy(load_pytree(f"{tmp}/adapters.npz"),
                                    "cpu")
    text_adapters0 = adapters_from_numpy(
        load_pytree(f"{tmp}/text_adapters.npz"), "cpu")
    views = torch.from_numpy(data["views"])
    canvases, hs, ws = (torch.from_numpy(data[k])
                        for k in ("canvases", "hs", "ws"))
    tokens = data["tokens"]

    def split(params):
        return params if mesh is None else shard_params(params, mesh)

    params = split(whole)
    out = {}

    def record(name, fn):
        seen, adamw = first_gradients()
        try:
            res = fn()
        finally:
            ttl._adamw = adamw
        out[name] = {k: v.tolist() for k, v in res.items()}
        if seen:
            out[name]["grad"] = seen[0].tolist()

    def lora(cfg, text_cls, n_classes):
        def fn():
            step = (make_batched_ttl_fn(TEST_TINY, cfg) if mesh is None else
                    make_sharded_ttl_fn(TEST_TINY, cfg, mesh,
                                        n_classes=n_classes))
            return {"logits": step(params, text_cls, adapters0,
                                   views).logits}
        return fn

    base = TTLConfig(**CFG_KW)
    for n in (5, 6):
        text_cls = torch.from_numpy(data[f"text_cls{n}"])
        record(f"image-LoRA, {n} classes", lora(base, text_cls, n))
    text_cls = torch.from_numpy(data["text_cls6"])
    record("TPT on LoRA", lora(base.replace(deyo_selection=False), text_cls,
                               6))

    def text_lora():
        cfg = base.replace(lora_encoder="text")
        step = make_batched_ttl_fn(TEST_TINY, cfg, tokens=tokens, mesh=mesh)
        return {"logits": step(params, None, text_adapters0, views).logits}
    record("text-LoRA", text_lora)

    def int8_prefix():
        cfg = base.replace(prefix_quant="int8")
        quant = split(attach_prefix_quant(whole, 2))
        step = make_batched_ttl_fn(TEST_TINY, cfg, mesh=mesh, n_classes=6)
        return {"logits": step(quant, text_cls, adapters0, views).logits}
    record("int8 prefix", int8_prefix)

    draws_idx = np.arange(canvases.shape[0])

    def fused(cfg, **kw):
        step = make_fused_ttl_fn(TEST_TINY, cfg, mesh=mesh, n_classes=6,
                                 **kw)
        draws = runner.sample_draws(cfg, draws_idx)
        res = step(params, text_cls, adapters0, canvases, hs, ws, draws)
        return {"logits": res.logits, "zero_shot": res.zero_shot_logits}

    record("PLPD", lambda: fused(base.replace(
        filter_plpd=1, plpd_threshold=0.0), zero_shot_aux=True))
    record("AugMix", lambda: fused(base.replace(
        aug_ops=("rotate", "equalize", "posterize")), zero_shot_aux=True))

    def prompt_tuning():
        cfg = base.replace(lora_encoder="prompt")
        pl_state = init_prompt_learner(whole["text"]["token_embed"].float(),
                                       CLASSES, cfg.ctx_init)
        res, ctx = make_fused_tpt_fn(TEST_TINY, cfg, mesh)(
            params, pl_state, canvases, hs, ws,
            runner.sample_draws(cfg, draws_idx))
        return {"logits": res.logits, "zero_shot": res.zero_shot_logits,
                "ctx": ctx}
    record("prompt tuning", prompt_tuning)

    def cocoop():
        cfg = base.replace(cocoop=True)
        state = init_cocoop(whole["text"]["token_embed"].float(), CLASSES,
                            TEST_TINY.vision.proj_dim,
                            torch.Generator().manual_seed(cfg.seed),
                            cfg.ctx_init)
        res = make_fused_cocoop_fn(TEST_TINY, cfg, mesh)(
            params, state, canvases, hs, ws,
            runner.sample_draws(cfg, draws_idx))
        return {"logits": res.logits, "adapted_logits": res.adapted_logits}
    record("CoCoOp", cocoop)

    def zero_shot():
        cfg = base.replace(tta_steps=0)
        return {"logits": make_fused_zeroshot_fn(TEST_TINY, cfg, mesh)(
            params, text_cls, canvases, hs, ws)}
    record("zero-shot", zero_shot)

    def fused_qkv():
        fused_p = split({**whole, "vision": fuse_qkv_params(whole["vision"])})
        with tp.over(None if mesh is None else mesh.model):
            feats = encode_image(fused_p["vision"], views[:, 0],
                                 TEST_TINY.vision,
                                 compute_dtype=torch.float32)
        return {"features": feats}
    record("fused qkv", fused_qkv)

    def run():
        cfg = base.replace(sample_batch=2, test_sets="eurosat",
                           print_freq=1000,
                           checkpoint_path=f"{tmp}/params.npz",
                           mesh_shape=None if mesh is None else (1, 2))
        images = np.asarray(canvases)[:, :80, :80]
        res = runner.run(cfg, device="cpu", datasets={
            "eurosat": ArrayDataset(images, np.array([3, 1, 4, 1]))})
        return {"top1/top5": torch.tensor(res["eurosat"])}
    record("runner", run)
    return out


def write_inputs(tmp, j_params, j_adapters, j_text_adapters, text_cls,
                 tokens, save_pytree) -> None:
    """The inputs `run_cases` reads, from numpy-made data and JAX's trees
    (`save_pytree` is the JAX package's, so the port reads JAX's layout)."""
    rng = np.random.default_rng(0)
    save_pytree(f"{tmp}/params.npz", j_params)
    save_pytree(f"{tmp}/adapters.npz", j_adapters)
    save_pytree(f"{tmp}/text_adapters.npz", j_text_adapters)
    canvases = np.zeros((4, 96, 96, 3), np.uint8)
    hs = np.array([96, 80, 64, 90], np.int64)
    ws = np.array([96, 96, 72, 64], np.int64)
    for i in range(4):
        canvases[i, :hs[i], :ws[i]] = rng.integers(0, 256, (hs[i], ws[i], 3))
    np.savez(f"{tmp}/data.npz",
             views=rng.standard_normal((8, 8, 3, 64, 64)).astype(np.float32),
             canvases=canvases, hs=hs, ws=ws, tokens=tokens,
             **{f"text_cls{n}": t for n, t in text_cls.items()})
