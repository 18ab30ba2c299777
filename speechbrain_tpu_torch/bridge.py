"""Turns the JAX package's parameters and state into this port's
``state_dict``s.

Inputs are nested dicts of arrays as the JAX modules' ``init`` returns
them (any array type numpy can read).  Layout changes:

- Dense ``kernel (in, out)`` -> ``weight (out, in)``;
- Conv2d ``kernel`` HWIO (H = time, W = frequency) -> OIHW;
- the depthwise ``(K, C)`` taps stay ``(K, C)``;
- ``q_proj``/``k_proj``/``v_proj`` stay separate (the modules
  concatenate them for the fused projections);
- LayerNorm ``scale`` -> ``weight`` (the port's LayerNorms use Flax's
  eps, 1e-6);
- BatchNorm ``scale``/``bias`` plus ``batch_stats`` ``mean``/``var``;
- ``InputNormalization``'s global state ``count``/``mean``/``std``.
"""

import numpy as np
import torch

__all__ = [
    "dense",
    "layer_norm",
    "relpos_mha",
    "mha",
    "ffn",
    "conv_module",
    "conformer_layer",
    "decoder_layer",
    "frontend_state_dict",
    "transformer_asr_state_dict",
    "input_norm_state_dict",
    "conformer_asr_state_dict",
]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _prefixed(prefix, sd):
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def dense(p):
    """Flax Dense {kernel (in, out)[, bias]} -> Linear {weight (out, in)[, bias]}."""
    sd = {"weight": _t(p["kernel"]).T.contiguous()}
    if "bias" in p:
        sd["bias"] = _t(p["bias"])
    return sd


def layer_norm(p):
    """Flax LayerNorm {scale, bias} -> {weight, bias}."""
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def relpos_mha(p):
    """RelPosMHAXL parameters."""
    sd = {}
    for name in ("q_proj", "k_proj", "v_proj", "pos_proj", "out_proj"):
        sd.update(_prefixed(name, dense(p[name])))
    sd["pos_bias_u"] = _t(p["pos_bias_u"])
    sd["pos_bias_v"] = _t(p["pos_bias_v"])
    return sd


def mha(p):
    """MultiheadAttention parameters (biased q/k/v/out projections)."""
    sd = {}
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        sd.update(_prefixed(name, dense(p[name])))
    return sd


def ffn(p):
    """PositionalwiseFeedForward {Dense_0, Dense_1} -> {w_1, w_2}."""
    return {**_prefixed("w_1", dense(p["Dense_0"])),
            **_prefixed("w_2", dense(p["Dense_1"]))}


def conv_module(p):
    """Conformer ConvolutionModule parameters."""
    sd = {
        **_prefixed("norm_in", layer_norm(p["LayerNorm_0"])),
        **_prefixed("pointwise_in", dense(p["Dense_0"])),
        "depthwise_kernel": _t(p["depthwise_kernel"]),
        **_prefixed("norm_mid", layer_norm(p["LayerNorm_1"])),
        **_prefixed("pointwise_out", dense(p["Dense_1"])),
    }
    if "depthwise_bias" in p:
        sd["depthwise_bias"] = _t(p["depthwise_bias"])
    return sd


def conformer_layer(p):
    """ConformerEncoderLayer parameters."""
    return {
        **_prefixed("norm_ffn1", layer_norm(p["LayerNorm_0"])),
        **_prefixed("ffn1", ffn(p["ffn1"])),
        **_prefixed("norm_mha", layer_norm(p["LayerNorm_1"])),
        **_prefixed("mha", relpos_mha(p["mha"])),
        **_prefixed("conv", conv_module(p["conv"])),
        **_prefixed("norm_ffn2", layer_norm(p["LayerNorm_2"])),
        **_prefixed("ffn2", ffn(p["ffn2"])),
        **_prefixed("norm_out", layer_norm(p["LayerNorm_3"])),
    }


def decoder_layer(p):
    """TransformerDecoderLayer parameters."""
    return {
        **_prefixed("self_attn", mha(p["self_attn"])),
        **_prefixed("cross_attn", mha(p["cross_attn"])),
        **_prefixed("norm1", layer_norm(p["LayerNorm_0"])),
        **_prefixed("norm2", layer_norm(p["LayerNorm_1"])),
        **_prefixed("norm3", layer_norm(p["LayerNorm_2"])),
        **_prefixed("ffn", ffn(p["PositionalwiseFeedForward_0"])),
    }


def _numbered(p, prefix):
    return [p[k] for k in sorted(
        (k for k in p if k.startswith(prefix)),
        key=lambda k: int(k.rsplit("_", 1)[1]),
    )]


def frontend_state_dict(variables):
    """ConvolutionFrontEnd {"params", "batch_stats"} -> state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    for i, conv in enumerate(_numbered(params, "Conv2d_")):
        kern = np.asarray(conv["Conv_0"]["kernel"])  # (kh, kw, in, out)
        sd[f"convs.{i}.weight"] = _t(kern.transpose(3, 2, 0, 1)).contiguous()
        sd[f"convs.{i}.bias"] = _t(conv["Conv_0"]["bias"])
    bn_params = _numbered(params, "BatchNorm1d_")
    bn_stats = _numbered(stats, "BatchNorm1d_")
    for i, (bp, bs) in enumerate(zip(bn_params, bn_stats)):
        sd[f"norms.{i}.weight"] = _t(bp["BatchNorm_0"]["scale"])
        sd[f"norms.{i}.bias"] = _t(bp["BatchNorm_0"]["bias"])
        sd[f"norms.{i}.running_mean"] = _t(bs["BatchNorm_0"]["mean"])
        sd[f"norms.{i}.running_var"] = _t(bs["BatchNorm_0"]["var"])
    return sd


def transformer_asr_state_dict(params):
    """TransformerASR (conformer encoder) params -> state_dict."""
    sd = {
        **_prefixed("custom_src_module", dense(params["custom_src_module"])),
        "custom_tgt_module.emb.weight":
            _t(params["custom_tgt_module"]["Embed_0"]["embedding"]),
    }
    enc, dec = params["encoder"], params["decoder"]
    for i, layer in enumerate(_numbered(enc, "layer_")):
        sd.update(_prefixed(f"encoder.layers.{i}", conformer_layer(layer)))
    sd.update(_prefixed("encoder.norm_out", layer_norm(enc["norm_out"])))
    for i, layer in enumerate(_numbered(dec, "layer_")):
        sd.update(_prefixed(f"decoder.layers.{i}", decoder_layer(layer)))
    sd.update(_prefixed("decoder.norm_out", layer_norm(dec["norm_out"])))
    return sd


def input_norm_state_dict(state):
    """GlobalNormState {count, mean, std} -> InputNormalization buffers."""
    return {k: _t(state[k]) for k in ("count", "mean", "std")}


def conformer_asr_state_dict(frontend_vars, transformer_params,
                             ctc_lin_params, seq_lin_params, norm_state):
    """Everything ``asr.ConformerASR`` holds, from the JAX pieces:
    frontend variables, TransformerASR params, the two Linear heads'
    params ({"Dense_0": {...}} or {kernel, bias}) and the global
    input-normalization state."""
    def head(p):
        return dense(p.get("Dense_0", p))

    return {
        **_prefixed("normalize", input_norm_state_dict(norm_state)),
        **_prefixed("frontend", frontend_state_dict(frontend_vars)),
        **_prefixed("transformer", transformer_asr_state_dict(transformer_params)),
        **_prefixed("ctc_lin", head(ctc_lin_params)),
        **_prefixed("seq_lin", head(seq_lin_params)),
    }
