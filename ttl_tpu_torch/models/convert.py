"""Weight bridge between the JAX package's parameter pytrees and the port,
and CLIP checkpoint loading.

The JAX package keeps parameters as nested dicts (and, for a ResNet tower's
blocks, lists) of arrays in the layout the port uses too ([in, out] linears,
layers stacked on axis 0), so the bridge is one tensor per leaf; a tower
whose q, k and v are fused into one `qkv` projection (`fuse_qkv_params` of
either package) bridges the same way. The one change of layout: the conv
kernels of a ResNet tower (a dict that holds `attnpool`), HWIO in the JAX
package, OIHW in the port. `np.asarray` of a JAX bfloat16 array is an
ml_dtypes array that `torch.from_numpy` refuses; such leaves go through
float32 and back to bfloat16, which is exact.

Checkpoints (the counterpart of the checkpoint half of
`ttl_tpu/models/convert.py`, numpy and torch only): HuggingFace `CLIPModel`
and OpenAI `clip` state dicts (ViT and ResNet) convert to a numpy tree in
the JAX package's layout, which `params_from_numpy` then moves to the
device. `save_pytree` writes that layout to a flat `.npz` under the keys
`jax.tree_util.keystr` gives, so each package reads the other's cache.
Conversion runs once at load time, on the host.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .clip import TOWERS, CLIPConfig, TextConfig, VisionConfig
from .resnet import ResNetVisionConfig, convert_openai_resnet


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def tensor_from_numpy(a, device, dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    a = np.asarray(a)
    if _is_bf16(a):
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def _prefix_q_from_numpy(tree: Any, device) -> Any:
    """The int8 prefix copy (`ops/quant.py`): `wq` stays int8, every other
    leaf (scales, biases, layernorms) is float32; zero-length stacks stay
    zero-length."""
    if isinstance(tree, dict):
        return {k: _prefix_q_from_numpy(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    return tensor_from_numpy(a, device, torch.int8 if a.dtype == np.int8
                             else torch.float32)


def params_from_numpy(tree: Any, device, param_dtype: Optional[torch.dtype]
                      = None) -> Any:
    """JAX parameter pytree (numpy leaves) -> the port's parameter dict.

    param_dtype None keeps every leaf's own dtype. Otherwise leaves with two
    or more axes become param_dtype and the rest float32, the rule the JAX
    runner applies to converted checkpoints. The int8 prefix copy under
    `prefix_q` keeps its own types either way. A ResNet tower's conv
    kernels go from HWIO to OIHW."""
    def walk(node, in_resnet):
        if isinstance(node, dict):
            in_resnet = in_resnet or "attnpool" in node
            return {k: (_prefix_q_from_numpy(v, device) if k == "prefix_q"
                        else walk(v, in_resnet)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, in_resnet) for v in node]
        a = np.asarray(node)
        if in_resnet and a.ndim == 4:
            a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
        if param_dtype is None:
            return tensor_from_numpy(a, device)
        return tensor_from_numpy(a, device,
                                 param_dtype if a.ndim >= 2 else torch.float32)

    return walk(tree, False)


def adapters_from_numpy(tree: Any, device) -> Any:
    """JAX `adapters0` pytree -> the port's adapters (float32 leaves)."""
    if isinstance(tree, dict):
        return {k: adapters_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device, torch.float32)


def prompt_learner_from_numpy(state: Any, device):
    """The JAX package's `PromptLearnerState` (any object with its fields,
    array leaves readable by numpy) -> the port's dataclass: float leaves
    keep their dtype, the token table and name lengths become int64."""
    from .prompts import PromptLearnerState

    def leaf(name, dtype=None):
        a = getattr(state, name)
        return None if a is None else tensor_from_numpy(a, device, dtype)

    return PromptLearnerState(
        ctx=leaf("ctx"), ctx_init=leaf("ctx_init"), prefix=leaf("prefix"),
        suffix=leaf("suffix"), tokenized=leaf("tokenized", torch.int64),
        name_lens=leaf("name_lens", torch.int64), n_ctx=int(state.n_ctx),
        prompt_prefix=str(state.prompt_prefix),
        ctx_position=str(state.ctx_position), cls=leaf("cls"),
        cls_init=leaf("cls_init"))


def cocoop_state_from_numpy(state: Any, device):
    """The JAX package's `CoCoOpState` (any object with its fields, array
    leaves readable by numpy) -> the port's dataclass, leaf by leaf: float
    leaves keep their dtype, the token table becomes int64."""
    from ..adapt.cocoop import CoCoOpState

    def leaf(name, dtype=None):
        return tensor_from_numpy(getattr(state, name), device, dtype)

    return CoCoOpState(
        ctx=leaf("ctx"), meta_w1=leaf("meta_w1"), meta_b1=leaf("meta_b1"),
        meta_w2=leaf("meta_w2"), meta_b2=leaf("meta_b2"),
        prefix=leaf("prefix"), suffix=leaf("suffix"),
        tokenized=leaf("tokenized", torch.int64), n_ctx=int(state.n_ctx))


def params_to_numpy(tree: Any) -> Any:
    """The port's parameters -> numpy in the JAX package's layout (bfloat16
    leaves as float32, a ResNet tower's conv kernels HWIO)."""
    def walk(node, in_resnet):
        if isinstance(node, dict):
            in_resnet = in_resnet or "attnpool" in node
            return {k: walk(v, in_resnet) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, in_resnet) for v in node]
        t = node.detach().cpu()
        a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        if in_resnet and a.ndim == 4:
            a = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        return a

    return walk(tree, False)


# ------------------------------------------------------------- checkpoints

def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _ln(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]).astype(np.float32),
            "bias": _np(sd[f"{prefix}.bias"]).astype(np.float32)}


def _linear_t(sd, prefix, dtype):
    out = {"w": _np(sd[f"{prefix}.weight"]).T.astype(dtype)}
    if f"{prefix}.bias" in sd:
        out["b"] = _np(sd[f"{prefix}.bias"]).astype(dtype)
    return out


def _stack(dicts):
    """Per-layer trees of one structure -> one tree, leaves stacked on a
    new leading layer axis."""
    if isinstance(dicts[0], dict):
        return {k: _stack([d[k] for d in dicts]) for k in dicts[0]}
    return np.stack(dicts)


def _hf_layer(sd, prefix, dtype):
    return {
        "ln1": _ln(sd, f"{prefix}.layer_norm1"),
        "ln2": _ln(sd, f"{prefix}.layer_norm2"),
        "attn": {
            "q": _linear_t(sd, f"{prefix}.self_attn.q_proj", dtype),
            "k": _linear_t(sd, f"{prefix}.self_attn.k_proj", dtype),
            "v": _linear_t(sd, f"{prefix}.self_attn.v_proj", dtype),
            "o": _linear_t(sd, f"{prefix}.self_attn.out_proj", dtype),
        },
        "mlp": {
            "fc1": _linear_t(sd, f"{prefix}.mlp.fc1", dtype),
            "fc2": _linear_t(sd, f"{prefix}.mlp.fc2", dtype),
        },
    }


def from_hf_state_dict(sd, cfg: CLIPConfig, param_dtype=np.float32):
    """HF CLIPModel.state_dict() -> {vision, text, logit_scale} numpy tree
    (the JAX package's layout)."""
    v, t = cfg.vision, cfg.text
    # conv [out, in, kh, kw] -> matmul [in*kh*kw, out]
    patch = _np(sd["vision_model.embeddings.patch_embedding.weight"])
    vision = {
        "patch_embed": patch.reshape(v.hidden, -1).T.astype(param_dtype),
        "class_embed": _np(sd["vision_model.embeddings.class_embedding"]
                           ).astype(param_dtype),
        "pos_embed": _np(sd["vision_model.embeddings.position_embedding.weight"]
                         ).astype(param_dtype),
        # "pre_layrnorm" is HF's actual (misspelled) parameter name
        "ln_pre": _ln(sd, "vision_model.pre_layrnorm"),
        "layers": _stack([_hf_layer(sd, f"vision_model.encoder.layers.{i}",
                                    param_dtype) for i in range(v.layers)]),
        "ln_post": _ln(sd, "vision_model.post_layernorm"),
        "proj": _np(sd["visual_projection.weight"]).T.astype(param_dtype),
    }
    text = {
        "token_embed": _np(sd["text_model.embeddings.token_embedding.weight"]
                           ).astype(param_dtype),
        "pos_embed": _np(sd["text_model.embeddings.position_embedding.weight"]
                         ).astype(param_dtype),
        "layers": _stack([_hf_layer(sd, f"text_model.encoder.layers.{i}",
                                    param_dtype) for i in range(t.layers)]),
        "ln_final": _ln(sd, "text_model.final_layer_norm"),
        "proj": _np(sd["text_projection.weight"]).T.astype(param_dtype),
    }
    return {"vision": vision, "text": text,
            "logit_scale": _np(sd["logit_scale"]).astype(np.float32)}


def _openai_layer(sd, prefix, d, dtype):
    wqkv = _np(sd[f"{prefix}.attn.in_proj_weight"])  # [3d, d]
    bqkv = _np(sd[f"{prefix}.attn.in_proj_bias"])
    qkv = [{"w": wqkv[i * d:(i + 1) * d].T.astype(dtype),
            "b": bqkv[i * d:(i + 1) * d].astype(dtype)} for i in range(3)]
    return {
        "ln1": _ln(sd, f"{prefix}.ln_1"),
        "ln2": _ln(sd, f"{prefix}.ln_2"),
        "attn": {"q": qkv[0], "k": qkv[1], "v": qkv[2],
                 "o": _linear_t(sd, f"{prefix}.attn.out_proj", dtype)},
        "mlp": {"fc1": _linear_t(sd, f"{prefix}.mlp.c_fc", dtype),
                "fc2": _linear_t(sd, f"{prefix}.mlp.c_proj", dtype)},
    }


def _openai_text(sd, t, param_dtype):
    return {
        "token_embed": _np(sd["token_embedding.weight"]).astype(param_dtype),
        "pos_embed": _np(sd["positional_embedding"]).astype(param_dtype),
        "layers": _stack([_openai_layer(
            sd, f"transformer.resblocks.{i}", t.hidden, param_dtype)
            for i in range(t.layers)]),
        "ln_final": _ln(sd, "ln_final"),
        "proj": _np(sd["text_projection"]).astype(param_dtype),
    }


def from_openai_state_dict(sd, cfg: CLIPConfig, param_dtype=np.float32):
    """OpenAI clip .pt state dict -> numpy tree (the JAX package's layout),
    for ViT ('visual.conv1' patchifies) and ModifiedResNet
    ('visual.attnpool' present) checkpoints."""
    v, t = cfg.vision, cfg.text
    if "visual.attnpool.positional_embedding" in sd:  # RN50 family
        return {"vision": convert_openai_resnet(sd, v, param_dtype),
                "text": _openai_text(sd, t, param_dtype),
                "logit_scale": _np(sd["logit_scale"]).astype(np.float32)}
    patch = _np(sd["visual.conv1.weight"]).reshape(v.hidden, -1).T
    vision = {
        "patch_embed": patch.astype(param_dtype),
        "class_embed": _np(sd["visual.class_embedding"]).astype(param_dtype),
        "pos_embed": _np(sd["visual.positional_embedding"]).astype(param_dtype),
        "ln_pre": _ln(sd, "visual.ln_pre"),
        "layers": _stack([_openai_layer(
            sd, f"visual.transformer.resblocks.{i}", v.hidden, param_dtype)
            for i in range(v.layers)]),
        "ln_post": _ln(sd, "visual.ln_post"),
        "proj": _np(sd["visual.proj"]).astype(param_dtype),  # already [in,out]
    }
    return {"vision": vision, "text": _openai_text(sd, t, param_dtype),
            "logit_scale": _np(sd["logit_scale"]).astype(np.float32)}


def infer_config_from_openai(sd) -> CLIPConfig:
    """The architecture of an OpenAI state dict, from its shapes alone (the
    reference's build_model derivation)."""
    def shape(k):
        return _np(sd[k]).shape

    def count(prefix, part):
        return len({k.split(".")[part] for k in sd if k.startswith(prefix)})

    t_width = shape("ln_final.weight")[0]
    t_layers = count("transformer.resblocks", 2)
    vocab, ctx = shape("token_embedding.weight")[0],         shape("positional_embedding")[0]
    if "visual.attnpool.positional_embedding" in sd:  # ModifiedResNet
        pos = shape("visual.attnpool.positional_embedding")
        embed_dim = shape("visual.attnpool.c_proj.weight")[0]
        vision = ResNetVisionConfig(
            layers=tuple(count(f"visual.layer{s + 1}.", 2) for s in range(4)),
            width=shape("visual.conv3.weight")[0], heads=pos[1] // 64,
            proj_dim=embed_dim,
            image_size=int(round((pos[0] - 1) ** 0.5)) * 32)
    else:
        width, patch = shape("visual.conv1.weight")[0],             shape("visual.conv1.weight")[-1]
        grid = int(round((shape("visual.positional_embedding")[0] - 1)
                         ** 0.5))
        embed_dim = shape("text_projection")[1]
        vision = VisionConfig(hidden=width,
                              layers=count("visual.transformer.resblocks", 3),
                              heads=width // 64, proj_dim=embed_dim,
                              patch=patch, image_size=patch * grid)
    return CLIPConfig(vision=vision, text=TextConfig(
        hidden=t_width, layers=t_layers, heads=t_width // 64,
        proj_dim=embed_dim, vocab=vocab, ctx=ctx))


def _keystr_leaves(tree, path=""):
    """(path, leaf) of every leaf, the path written as
    `jax.tree_util.keystr` writes it: "['vision']['layer1'][0]['conv1']"."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _keystr_leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _keystr_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def save_pytree(path: str, params) -> None:
    """Cache the port's parameters as a flat .npz in the JAX package's
    layout (`params_to_numpy`), under its keys."""
    np.savez(path, **dict(_keystr_leaves(params_to_numpy(params))))


def load_pytree(path: str):
    """Inverse of save_pytree: the nested dict/list numpy tree, in the JAX
    package's layout, from a keystr-flattened .npz (either package's)."""
    root: dict = {}
    with np.load(path) as flat:
        for keystr, value in flat.items():
            parts = [p.strip("'\"") for p in
                     keystr.replace("]", "").split("[") if p]
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_checkpoint(path: str, cfg: CLIPConfig = None,
                    param_dtype=np.float32):
    """A local CLIP checkpoint: torch .pt/.bin (HF or OpenAI layout, told
    apart by its keys), .safetensors, or a .npz cache of `save_pytree`.
    Returns (numpy tree in the JAX package's layout, cfg); an OpenAI
    checkpoint read without `cfg` gives its config from its shapes. A ViT
    tower that no converter reads (`ViTTower.converter`) raises before
    anything is read."""
    v = None if cfg is None else cfg.vision
    if isinstance(v, VisionConfig) and not TOWERS[v.tower].converter:
        name = v.tower.upper()
        raise ValueError(f"--checkpoint_path: no converter reads {name} "
                         f"checkpoints; the {name} tower runs on random "
                         "weights")
    path = str(path)
    if path.endswith(".npz"):
        if cfg is None:
            raise ValueError(".npz pytree cache requires an explicit config")
        return load_pytree(path), cfg
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file
        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        if "state_dict" in sd:
            sd = sd["state_dict"]
    if any(k.startswith("vision_model.") for k in sd):
        if cfg is None:
            raise ValueError("HF layout requires an explicit CLIPConfig")
        return from_hf_state_dict(sd, cfg, param_dtype), cfg
    cfg = cfg or infer_config_from_openai(sd)
    return from_openai_state_dict(sd, cfg, param_dtype), cfg
