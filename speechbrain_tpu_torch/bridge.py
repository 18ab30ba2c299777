"""Turns the JAX package's parameters and state into this port's
``state_dict``s, and back (``to_jax_*``).

Inputs are nested dicts of arrays as the JAX modules' ``init`` returns
them (any array type numpy can read); the ``to_jax_*`` functions return
such dicts of float32 numpy arrays, in the JAX layout.  Layout changes:

- Dense ``kernel (in, out)`` -> ``weight (out, in)``;
- Conv2d ``kernel`` HWIO (H = time, W = frequency) -> OIHW;
- the depthwise ``(K, C)`` taps stay ``(K, C)``;
- ``q_proj``/``k_proj``/``v_proj`` stay separate (the modules
  concatenate them for the fused projections);
- LayerNorm ``scale`` -> ``weight`` (the port's LayerNorms use Flax's
  eps, 1e-6);
- BatchNorm ``scale``/``bias`` plus ``batch_stats`` ``mean``/``var``;
- ``InputNormalization``'s global state ``count``/``mean``/``std``;
- GRU ``l{i}_wx`` Dense ``(in, 3H)`` + bias -> ``weight_ih``/``bias_ih``,
  ``l{i}_u (H, 3H)`` -> ``weight_hh``, ``l{i}_u_bias`` -> ``bias_hh``
  (``_bwd`` -> the ``_reverse`` direction), gates r, z, n in both; the
  LSTM's (gates i, f, g, o, ``(in, 4H)``) and the RNN's likewise, with a
  zero ``bias_hh`` (a buffer: JAX's LSTM and RNN have no recurrent bias);
- ``Embed_0.embedding`` -> ``weight`` (nothing in one-hot mode);
- LiGRU ``l{i}_wx`` Dense ``(in, 2H)`` (no bias) -> ``layers.{i}.wx.weight``,
  ``l{i}_bn`` BatchNorm (and its ``batch_stats``) -> ``layers.{i}.bn``,
  ``l{i}_u (H, 2H)`` -> ``layers.{i}.weight_hh (2H, H)``;
- CRDNN ``cnn_{i}`` (``Conv2d_{j}`` and ``LayerNorm_{j}``, scale and bias
  of shape (F, C)) -> ``cnn.{i}.convs.{j}``/``cnn.{i}.norms.{j}``, the
  projection ``Dense_0`` -> ``proj``, ``rnn`` -> the LiGRU, LSTM or GRU,
  ``dnn_{i}`` (``Dense_0``, ``BatchNorm1d_0``) -> ``dnn.{i}.linear``/
  ``dnn.{i}.norm``;
- Conv1d ``kernel`` (k, in / groups, out) -> ``weight`` (out, in / groups,
  k);
- ``Xvector``: ``Conv1d_{i}``/``BatchNorm1d_{i}`` -> ``blocks.{i}.conv``/
  ``blocks.{i}.norm``, ``Dense_0`` -> ``lin``; ``Classifier``:
  ``Dense_{i}``/``BatchNorm1d_{i}`` of its ``lin_blocks`` ->
  ``blocks.{i}.linear``/``blocks.{i}.norm``, then ``Dense_{lin_blocks}``
  -> ``out``, or ``centroids`` as it is;
- ``ECAPA_TDNN``: ``block_0`` -> ``blocks.0``, ``serez_{i}_in``/
  ``_res2``/``_out``/``_se`` -> ``blocks.{i}.tdnn1``/``.res2net``/
  ``.tdnn2``/``.se``, ``mfa``, ``asp`` (``TDNNBlock_0``, ``Conv1d_0`` ->
  ``tdnn``, ``conv``), ``asp_bn``, ``fc``; inside them a ``TDNNBlock``'s
  ``Conv1d_0``/``BatchNorm1d_0`` -> ``conv``/``norm``, a Res2Net's
  ``block_{i}`` -> ``blocks.{i - 1}``, an SE block's ``Conv1d_0``/``_1``
  -> ``conv1``/``conv2``; ``SERes2NetBlock``'s ``tdnn1``, ``res2net``,
  ``tdnn2``, ``se`` and ``shortcut`` (a plain Flax ``Conv``) keep their
  names; the ECAPA ``Classifier``'s ``weight`` (lin, out) stays as it is,
  its ``Dense_{i}``/``BatchNorm1d_{i}`` -> ``blocks.{i}.linear``/
  ``blocks.{i}.norm``;
- ``ConvTranspose1d``'s ``kernel`` (k, in, out), which Flax applies
  without flipping its taps, -> ``weight`` (in, out, k) with the taps
  reversed (PyTorch's transposed convolution flips them);
- a 1x1 ``Conv1d`` ``kernel`` (1, in, out) that the port runs as a
  ``Linear`` -> ``weight`` (out, in);
- ``SepformerWrapper``: ``Encoder_0`` -> ``encoder.conv``,
  ``Dual_Path_Model_0``'s ``LayerNorm_0``/``Conv1d_0`` -> ``masknet.norm``/
  ``masknet.conv1d``, ``intra_{l}``/``inter_{l}`` (a ``TransformerEncoder_0``,
  a conformer ``encoder`` or an ``SBRNNBlock``'s ``LSTM_0``) ->
  ``masknet.intra.{l}.mdl``/
  ``masknet.inter.{l}.mdl``, ``LayerNorm_{2l+1}``/``LayerNorm_{2l+2}`` ->
  ``masknet.intra_norm.{l}``/``masknet.inter_norm.{l}``, ``PReLU_0`` ->
  ``masknet.prelu``, ``Conv1d_1`` -> ``masknet.conv_out``, ``Decoder_0`` ->
  ``decoder.conv``;
- ``SkiMSeparator`` (and ``ResepformerWrapper``): ``Encoder_0``/
  ``Decoder_0`` as above, ``masknet.pipeline``'s ``seg_{i}``/``mem_{i}``
  -> ``masknet.pipeline.seg.{i}``/``.mem.{i}`` (a SegLSTM's ``lstm``,
  ``proj``, ``norm``; a MemLSTM's ``h_net``/``c_net``, ``*_proj``,
  ``*_norm``; a transformer segment's ``block`` (its
  ``TransformerEncoder_0`` -> ``block.mdl``) and ``norm``), ``output_fc``;
  ``RESepformer``: ``intra_{i}``/``inter_{i}`` -> ``intra.{i}.mdl``/
  ``inter.{i}.mdl``, the 1x1 ``mask_out`` -> ``mask_out``;
- ``ConvTasNet``: ``Encoder_0.conv1d_U`` -> ``encoder.conv``, ``MaskNet_0``'s
  ``layer_norm``, ``bottleneck_conv1x1``, ``mask_conv1x1`` ->
  ``masknet.layer_norm``, ``.bottleneck``, ``.mask_conv``, its
  ``temporalblock_{r}_{i}`` -> ``masknet.temporal_conv_net.{r X + i}``
  (``conv``, ``act``, ``norm``, and ``DSconv``'s ``conv_0``/``act``/``norm``/
  ``conv_1`` -> ``dsconv.depthwise``/``.act``/``.norm``/``.pointwise``),
  ``Decoder_0.basis_signals`` -> ``decoder.basis``; a PReLU's
  ``negative_slope`` and a gLN/cLN's ``gamma``/``beta`` -> ``weight``/
  ``bias``; ``BinauralConvTasNet``: each ear's ``encoder_{l,r}``,
  ``masknet_{l,r}`` and ``decoder_{l,r}`` likewise, ``ild_proj`` as it is;
- ``CNNTransformerSE``: ``in_proj``, ``TransformerEncoder_0`` ->
  ``encoder``, ``Dense_0`` -> ``output_layer`` (``SpectralMaskWrapper``:
  under ``masker``); the dual-path blocks: ``PytorchTransformerBlock``'s
  ``encoder``, ``DPTNetBlock``'s ``mha``/``norm1``/``rnn_ffn`` (a GRU)/
  ``ffn_out``/``norm2``, ``Dual_Computation_Block``'s ``{intra,inter}_mdl``
  (``TransformerEncoder_0`` -> ``.mdl``), ``_lin`` and ``_norm``;
- ``TransformerLM``: ``NormalizedEmbedding_0`` -> ``emb.emb``, the
  optional ``d_embedding`` projection ``Dense_0`` -> ``emb_proj``, the
  last ``Dense_*`` -> ``output_proj``, ``TransformerEncoder_0`` ->
  ``encoder`` (each layer's attention ``MultiheadAttention_0`` or
  ``RelPosMHAXL_0`` -> ``self_attn``, ``LayerNorm_0``/``_1`` ->
  ``norm1``/``norm2``, ``PositionalwiseFeedForward_0`` -> ``ffn``);
- the single-step cells' ``l{i}_wx``/``l{i}_u`` Dense layers ->
  ``wx.{i}``/``u.{i}`` (the GRU cell's ``u`` has a bias, the LSTM's and
  RNN's none); the RNN attentions' Dense layers keep their names, the
  location conv's ``conv_loc`` kernel (K, 1, C) -> ``weight`` (C, 1, K);
  ``AttentionalRNNDecoder``'s ``rnn``, ``attn`` and ``proj`` keep theirs;
- ``RNNLM``: ``Embedding_0`` -> ``emb``, ``LSTM_0`` -> ``rnn``, the DNN
  blocks' ``Dense_{i}``/``LayerNorm_{i}`` -> ``dnn.{i}.linear``/
  ``dnn.{i}.norm``, the last ``Dense_*`` -> ``out``;
- ``TransformerST``: ``st`` -> ``st`` (a ``TransformerASR``), the
  branches' ``asr_decoder`` (a ``TransformerDecoder``), ``mt_encoder`` (a
  ``TransformerEncoder``), ``custom_asr_tgt_module`` and
  ``custom_mt_src_module`` (``NormalizedEmbedding``s) keep their names;
- ``ConformerDecoder``: ``layer_{i}`` -> ``layers.{i}`` (``LayerNorm_0``/
  ``_1`` -> ``norm_ffn1``/``norm_ffn2``; ``ffn1``, ``norm1``, ``mha`` (a
  ``MultiheadAttention`` or a ``RelPosMHAXL``), ``conv``, ``ffn2`` and
  ``norm2`` keep their names), ``norm`` as it is.

The optimizer's state: optax ``adamw``'s ``mu``, ``nu`` and ``count``
are torch ``AdamW``'s ``exp_avg``, ``exp_avg_sq`` and ``step``
(``adamw_state_to_torch`` and back, ``adamw_state_from_torch``).  The
moments have the parameters' tree, so the converters above put them in
the port's layout (each layout change is a permutation, which commutes
with Adam's elementwise update); the functions here key them by
parameter order, as ``torch.optim`` does.
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
    "to_jax_conformer_asr",
    "gru",
    "embedding",
    "conformer_transducer_state_dict",
    "to_jax_gru",
    "lstm",
    "to_jax_lstm",
    "rnn",
    "to_jax_rnn",
    "to_jax_conformer_transducer",
    "ligru_state_dict",
    "to_jax_ligru",
    "crdnn_state_dict",
    "to_jax_crdnn",
    "crdnn_transducer_state_dict",
    "to_jax_crdnn_transducer",
    "conv1d",
    "xvector_state_dict",
    "classifier_state_dict",
    "to_jax_xvector",
    "to_jax_classifier",
    "ecapa_state_dict",
    "to_jax_ecapa",
    "seres2net_state_dict",
    "to_jax_seres2net",
    "ecapa_classifier_state_dict",
    "to_jax_ecapa_classifier",
    "encoder_layer",
    "transformer_lm_state_dict",
    "to_jax_transformer_lm",
    "conv_transpose1d",
    "to_jax_conv_transpose1d",
    "sepformer_state_dict",
    "to_jax_sepformer",
    "skim_state_dict",
    "to_jax_skim",
    "resepformer_state_dict",
    "to_jax_resepformer",
    "convtasnet_state_dict",
    "to_jax_convtasnet",
    "binaural_convtasnet_state_dict",
    "to_jax_binaural_convtasnet",
    "cnn_transformer_se_state_dict",
    "to_jax_cnn_transformer_se",
    "spectral_mask_state_dict",
    "to_jax_spectral_mask",
    "pytorch_transformer_block_state_dict",
    "to_jax_pytorch_transformer_block",
    "dptnet_block_state_dict",
    "to_jax_dptnet_block",
    "dual_computation_block_state_dict",
    "to_jax_dual_computation_block",
    "rnn_cell",
    "to_jax_rnn_cell",
    "rnn_attention",
    "to_jax_rnn_attention",
    "attentional_rnn_decoder",
    "to_jax_attentional_rnn_decoder",
    "rnnlm_state_dict",
    "to_jax_rnnlm",
    "crdnn_seq2seq_state_dict",
    "to_jax_crdnn_seq2seq",
    "transformer_st_state_dict",
    "to_jax_transformer_st",
    "conformer_decoder_state_dict",
    "to_jax_conformer_decoder",
    "speech_translator_state_dict",
    "to_jax_speech_translator",
    "w2v_extractor_state_dict",
    "w2v_quantiser_state_dict",
    "w2v_encoder_state_dict",
    "vanilla_nn_state_dict",
    "wav2vec_state_dict",
    "to_jax_wav2vec",
    "adamw_state_to_torch",
    "adamw_state_from_torch",
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


def encoder_layer(p):
    """TransformerEncoderLayer parameters (either attention type)."""
    if "RelPosMHAXL_0" in p:
        attn = relpos_mha(p["RelPosMHAXL_0"])
    else:
        attn = mha(p["MultiheadAttention_0"])
    return {
        **_prefixed("self_attn", attn),
        **_prefixed("norm1", layer_norm(p["LayerNorm_0"])),
        **_prefixed("norm2", layer_norm(p["LayerNorm_1"])),
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
    """TransformerASR params (conformer or transformer encoder: a
    conformer layer holds ``ffn1``) -> state_dict; an encoder-only model
    (0 decoder layers) has no target embedding and no decoder."""
    sd = _prefixed("custom_src_module", dense(params["custom_src_module"]))
    if "custom_tgt_module" in params:
        sd["custom_tgt_module.emb.weight"] = _t(
            params["custom_tgt_module"]["Embed_0"]["embedding"])
    enc = params["encoder"]
    for i, layer in enumerate(_numbered(enc, "layer_")):
        convert = conformer_layer if "ffn1" in layer else encoder_layer
        sd.update(_prefixed(f"encoder.layers.{i}", convert(layer)))
    sd.update(_prefixed("encoder.norm_out", layer_norm(enc["norm_out"])))
    if "decoder" in params:
        dec = params["decoder"]
        for i, layer in enumerate(_numbered(dec, "layer_")):
            sd.update(_prefixed(f"decoder.layers.{i}", decoder_layer(layer)))
        sd.update(_prefixed("decoder.norm_out", layer_norm(dec["norm_out"])))
    return sd


def transformer_lm_state_dict(params):
    """TransformerLM params -> the port's ``TransformerLM`` state_dict."""
    sd = {"emb.emb.weight": _t(
        params["NormalizedEmbedding_0"]["Embed_0"]["embedding"])}
    denses = _numbered(params, "Dense_")
    if len(denses) == 2:  # the d_embedding projection, then the output
        sd.update(_prefixed("emb_proj", dense(denses[0])))
    sd.update(_prefixed("output_proj", dense(denses[-1])))
    enc = params["TransformerEncoder_0"]
    for i, layer in enumerate(_numbered(enc, "layer_")):
        sd.update(_prefixed(f"encoder.layers.{i}", encoder_layer(layer)))
    sd.update(_prefixed("encoder.norm_out", layer_norm(enc["norm_out"])))
    return sd


def input_norm_state_dict(state):
    """GlobalNormState {count, mean, std} -> InputNormalization buffers."""
    return {k: _t(state[k]) for k in ("count", "mean", "std")}


def _head(p):
    """A ``Linear``'s params ({"Dense_0": {...}} or {kernel, bias})."""
    return dense(p.get("Dense_0", p))


def conformer_asr_state_dict(frontend_vars, transformer_params,
                             ctc_lin_params, seq_lin_params, norm_state):
    """Everything ``asr.ConformerASR`` holds, from the JAX pieces:
    frontend variables, TransformerASR params, the two Linear heads'
    params ({"Dense_0": {...}} or {kernel, bias}) and the global
    input-normalization state."""
    return {
        **_prefixed("normalize", input_norm_state_dict(norm_state)),
        **_prefixed("frontend", frontend_state_dict(frontend_vars)),
        **_prefixed("transformer", transformer_asr_state_dict(transformer_params)),
        **_prefixed("ctc_lin", _head(ctc_lin_params)),
        **_prefixed("seq_lin", _head(seq_lin_params)),
    }


def _recurrent(p, gates):
    """JAX GRU/LSTM/RNN params -> the port's module's state_dict
    (``rnns.{i}``, one one-layer ``torch.nn`` recurrence per layer); the
    recurrent bias is the GRU's ``l{i}_u_bias``, zeros for the others."""
    sd = {}
    layers = sorted({int(k[1:].split("_")[0]) for k in p})
    for i in layers:
        for name, suffix in ((f"l{i}", ""), (f"l{i}_bwd", "_reverse")):
            if f"{name}_wx" not in p:
                continue
            wx = dense(p[f"{name}_wx"])
            u = _t(p[f"{name}_u"]).T.contiguous()
            if u.shape[0] != gates * u.shape[1]:
                raise ValueError(f"{name}_u {tuple(u.shape)[::-1]}: not "
                                 f"(H, {gates} H)")
            sd[f"rnns.{i}.weight_ih_l0{suffix}"] = wx["weight"]
            sd[f"rnns.{i}.weight_hh_l0{suffix}"] = u
            sd[f"rnns.{i}.bias_ih_l0{suffix}"] = wx["bias"]
            sd[f"rnns.{i}.bias_hh_l0{suffix}"] = (
                _t(p[f"{name}_u_bias"]) if f"{name}_u_bias" in p
                else torch.zeros(u.shape[0]))
    return sd


def gru(p):
    """JAX GRU params -> the port's ``GRU`` state_dict."""
    return _recurrent(p, 3)


def lstm(p):
    """JAX LSTM params -> the port's ``LSTM`` state_dict (``bias_hh``
    zero)."""
    return _recurrent(p, 4)


def rnn(p):
    """JAX RNN params -> the port's ``RNN`` state_dict (``bias_hh``
    zero)."""
    return _recurrent(p, 1)


def embedding(p):
    """Flax ``Embedding`` params ({"Embed_0": {"embedding"}}, or nothing
    in one-hot mode) -> {weight (num, dim)}."""
    if "Embed_0" not in p:
        return {}
    return {"weight": _t(p["Embed_0"]["embedding"])}


def conformer_transducer_state_dict(frontend_vars, transformer_params,
                                    enc_lin, emb, dec, dec_lin, out_lin,
                                    norm_state):
    """Everything ``asr.ConformerTransducer`` holds, from the JAX pieces:
    frontend variables, the encoder-only TransformerASR params, the
    ``enc_lin``/``dec_lin``/``out_lin`` Linear params, the ``emb``
    Embedding and ``dec`` GRU params and the global input-normalization
    state."""
    return {
        **_prefixed("normalize", input_norm_state_dict(norm_state)),
        **_prefixed("frontend", frontend_state_dict(frontend_vars)),
        **_prefixed("transformer", transformer_asr_state_dict(transformer_params)),
        **_prefixed("enc_lin", _head(enc_lin)),
        **_prefixed("emb", embedding(emb)),
        **_prefixed("dec", gru(dec)),
        **_prefixed("dec_lin", _head(dec_lin)),
        **_prefixed("out_lin", _head(out_lin)),
    }


def _batch_norm(p, stats):
    """Flax BatchNorm {scale, bias} and its batch_stats {mean, var} ->
    the port's ``BatchNorm1d`` state_dict."""
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"]),
            "running_mean": _t(stats["mean"]),
            "running_var": _t(stats["var"])}


def ligru_state_dict(params, batch_stats):
    """JAX LiGRU params and batch_stats -> the port's ``LiGRU``
    state_dict."""
    sd = {}
    layers = sorted({int(k[1:].split("_")[0]) for k in params})
    for i in layers:
        sd[f"layers.{i}.wx.weight"] = _t(params[f"l{i}_wx"]["kernel"]).T.contiguous()
        sd.update(_prefixed(f"layers.{i}.bn", _batch_norm(
            params[f"l{i}_bn"], batch_stats[f"l{i}_bn"])))
        sd[f"layers.{i}.weight_hh"] = _t(params[f"l{i}_u"]).T.contiguous()
    return sd


def crdnn_state_dict(params, batch_stats):
    """JAX ``CRDNN`` params and batch_stats -> the port's ``CRDNN``
    state_dict."""
    sd = {}
    for i, block in enumerate(_numbered(params, "cnn_")):
        for j, conv in enumerate(_numbered(block, "Conv2d_")):
            kern = np.asarray(conv["Conv_0"]["kernel"])  # (kh, kw, in, out)
            sd[f"cnn.{i}.convs.{j}.weight"] = _t(
                kern.transpose(3, 2, 0, 1)).contiguous()
            sd[f"cnn.{i}.convs.{j}.bias"] = _t(conv["Conv_0"]["bias"])
        for j, norm in enumerate(_numbered(block, "LayerNorm_")):
            sd.update(_prefixed(f"cnn.{i}.norms.{j}",
                                layer_norm(norm["LayerNorm_0"])))
    if "Dense_0" in params:
        sd.update(_prefixed("proj", dense(params["Dense_0"])))
    rnn = params["rnn"]
    if "l0_bn" in rnn:
        sd.update(_prefixed("rnn", ligru_state_dict(rnn, batch_stats["rnn"])))
    else:
        gates = np.shape(rnn["l0_u"])[1] // np.shape(rnn["l0_u"])[0]
        sd.update(_prefixed("rnn", _recurrent(rnn, gates)))
    for i, block in enumerate(_numbered(params, "dnn_")):
        sd.update(_prefixed(f"dnn.{i}.linear", dense(block["Dense_0"])))
        sd.update(_prefixed(f"dnn.{i}.norm", _batch_norm(
            block["BatchNorm1d_0"]["BatchNorm_0"],
            batch_stats[f"dnn_{i}"]["BatchNorm1d_0"]["BatchNorm_0"])))
    return sd


def crdnn_transducer_state_dict(enc_vars, enc_lin, emb, dec, dec_lin,
                                out_lin, norm_state):
    """Everything ``asr.CRDNNTransducer`` holds, from the JAX pieces: the
    ``CRDNN`` encoder's variables ``{"params", "batch_stats"}``, the
    ``enc_lin``/``dec_lin``/``out_lin`` Linear params, the ``emb``
    Embedding and ``dec`` GRU params and the global input-normalization
    state."""
    return {
        **_prefixed("normalize", input_norm_state_dict(norm_state)),
        **_prefixed("enc", crdnn_state_dict(enc_vars["params"],
                                            enc_vars["batch_stats"])),
        **_prefixed("enc_lin", _head(enc_lin)),
        **_prefixed("emb", embedding(emb)),
        **_prefixed("dec", gru(dec)),
        **_prefixed("dec_lin", _head(dec_lin)),
        **_prefixed("out_lin", _head(out_lin)),
    }


def conv1d(p):
    """Flax Conv {kernel (k, in / groups, out), bias} -> ``Conv1d``
    {weight (out, in / groups, k), bias}."""
    sd = {"weight": _t(np.asarray(p["kernel"]).transpose(2, 1, 0)).contiguous()}
    if "bias" in p:
        sd["bias"] = _t(p["bias"])
    return sd


def _inner_bn(params, stats, name):
    return _batch_norm(params[name]["BatchNorm_0"], stats[name]["BatchNorm_0"])


def xvector_state_dict(variables):
    """JAX ``Xvector`` variables ``{"params", "batch_stats"}`` -> the
    port's ``Xvector`` state_dict."""
    p, st = variables["params"], variables["batch_stats"]
    sd = {}
    for i, conv in enumerate(_numbered(p, "Conv1d_")):
        sd.update(_prefixed(f"blocks.{i}.conv", conv1d(conv["Conv_0"])))
        sd.update(_prefixed(f"blocks.{i}.norm",
                            _inner_bn(p, st, f"BatchNorm1d_{i}")))
    sd.update(_prefixed("lin", dense(p["Dense_0"])))
    return sd


def classifier_state_dict(variables):
    """JAX ``Classifier`` variables ``{"params", "batch_stats"}`` -> the
    port's ``Classifier`` state_dict."""
    p, st = variables["params"], variables["batch_stats"]
    denses = _numbered(p, "Dense_")
    n_blocks = len(_numbered(p, "BatchNorm1d_"))
    sd = {}
    for i in range(n_blocks):
        sd.update(_prefixed(f"blocks.{i}.linear", dense(denses[i])))
        sd.update(_prefixed(f"blocks.{i}.norm",
                            _inner_bn(p, st, f"BatchNorm1d_{i}")))
    if "centroids" in p:
        sd["centroids"] = _t(p["centroids"])
    else:
        sd.update(_prefixed("out", dense(denses[n_blocks])))
    return sd


def _tdnn_block(p, st):
    return {**_prefixed("conv", conv1d(p["Conv1d_0"]["Conv_0"])),
            **_prefixed("norm", _inner_bn(p, st, "BatchNorm1d_0"))}


def _seres2net(p, st, names):
    """One SE-Res2Net block; ``names`` maps the port's ``tdnn1``,
    ``res2net``, ``tdnn2``, ``se`` (and ``shortcut``) to the JAX names."""
    sd = {**_prefixed("tdnn1", _tdnn_block(p[names["tdnn1"]],
                                           st[names["tdnn1"]])),
          **_prefixed("tdnn2", _tdnn_block(p[names["tdnn2"]],
                                           st[names["tdnn2"]]))}
    res2, res2_st = p[names["res2net"]], st[names["res2net"]]
    for i in range(1, len(res2) + 1):
        sd.update(_prefixed(f"res2net.blocks.{i - 1}", _tdnn_block(
            res2[f"block_{i}"], res2_st[f"block_{i}"])))
    se = p[names["se"]]
    sd.update(_prefixed("se.conv1", conv1d(se["Conv1d_0"]["Conv_0"])))
    sd.update(_prefixed("se.conv2", conv1d(se["Conv1d_1"]["Conv_0"])))
    if "shortcut" in p:
        sd.update(_prefixed("shortcut", conv1d(p["shortcut"])))
    return sd


_SERES2NET_NAMES = {k: k for k in ("tdnn1", "res2net", "tdnn2", "se")}


def seres2net_state_dict(variables):
    """JAX ``SERes2NetBlock`` variables ``{"params", "batch_stats"}`` ->
    the port's ``SERes2NetBlock`` state_dict."""
    return _seres2net(variables["params"], variables["batch_stats"],
                      _SERES2NET_NAMES)


def ecapa_state_dict(variables):
    """JAX ``ECAPA_TDNN`` variables ``{"params", "batch_stats"}`` -> the
    port's ``ECAPA_TDNN`` state_dict."""
    p, st = variables["params"], variables["batch_stats"]
    sd = _prefixed("blocks.0", _tdnn_block(p["block_0"], st["block_0"]))
    n = len([k for k in p if k.startswith("serez_") and k.endswith("_in")])
    for i in range(1, n + 1):
        names = {"tdnn1": f"serez_{i}_in", "res2net": f"serez_{i}_res2",
                 "tdnn2": f"serez_{i}_out", "se": f"serez_{i}_se"}
        sd.update(_prefixed(f"blocks.{i}", _seres2net(p, st, names)))
    sd.update(_prefixed("mfa", _tdnn_block(p["mfa"], st["mfa"])))
    sd.update(_prefixed("asp.tdnn", _tdnn_block(p["asp"]["TDNNBlock_0"],
                                                st["asp"]["TDNNBlock_0"])))
    sd.update(_prefixed("asp.conv", conv1d(p["asp"]["Conv1d_0"]["Conv_0"])))
    sd.update(_prefixed("asp_bn", _batch_norm(p["asp_bn"]["BatchNorm_0"],
                                              st["asp_bn"]["BatchNorm_0"])))
    sd.update(_prefixed("fc", conv1d(p["fc"]["Conv_0"])))
    return sd


def ecapa_classifier_state_dict(variables):
    """JAX ECAPA ``Classifier`` variables ``{"params"[, "batch_stats"]}``
    -> the port's ``ECAPA_TDNN.Classifier`` state_dict."""
    p, st = variables["params"], variables.get("batch_stats", {})
    denses = _numbered(p, "Dense_")
    sd = {"weight": _t(p["weight"])}
    for i in range(len(denses)):
        sd.update(_prefixed(f"blocks.{i}.linear", dense(denses[i])))
        sd.update(_prefixed(f"blocks.{i}.norm",
                            _inner_bn(p, st, f"BatchNorm1d_{i}")))
    return sd


# ------------------------------------------------------------------
# port state_dict -> JAX layout (the inverse of the functions above)


def _a(t):
    return t.detach().float().cpu().numpy()


class _Sub:
    """The entries of a state_dict under a prefix."""

    def __init__(self, sd, prefix=""):
        self.sd, self.prefix = sd, prefix

    def __getitem__(self, key):
        return self.sd[self.prefix + key]

    def __contains__(self, key):
        return self.prefix + key in self.sd

    def sub(self, name):
        return _Sub(self.sd, f"{self.prefix}{name}.")

    def count(self, name):
        """How many numbered children ``name.<i>`` there are."""
        head = f"{self.prefix}{name}."
        return len({k[len(head):].split(".")[0] for k in self.sd
                    if k.startswith(head)})


def _dense_to_jax(s):
    p = {"kernel": _a(s["weight"]).T.copy()}
    if "bias" in s:
        p["bias"] = _a(s["bias"])
    return p


def _ln_to_jax(s):
    return {"scale": _a(s["weight"]), "bias": _a(s["bias"])}


def _ffn_to_jax(s):
    return {"Dense_0": _dense_to_jax(s.sub("w_1")),
            "Dense_1": _dense_to_jax(s.sub("w_2"))}


def _conv_module_to_jax(c):
    conv = {
        "LayerNorm_0": _ln_to_jax(c.sub("norm_in")),
        "Dense_0": _dense_to_jax(c.sub("pointwise_in")),
        "depthwise_kernel": _a(c["depthwise_kernel"]),
        "LayerNorm_1": _ln_to_jax(c.sub("norm_mid")),
        "Dense_1": _dense_to_jax(c.sub("pointwise_out")),
    }
    if "depthwise_bias" in c:
        conv["depthwise_bias"] = _a(c["depthwise_bias"])
    return conv


def _conformer_layer_to_jax(s):
    mha = {n: _dense_to_jax(s.sub(f"mha.{n}"))
           for n in ("q_proj", "k_proj", "v_proj", "pos_proj", "out_proj")}
    mha["pos_bias_u"] = _a(s["mha.pos_bias_u"])
    mha["pos_bias_v"] = _a(s["mha.pos_bias_v"])
    return {
        "LayerNorm_0": _ln_to_jax(s.sub("norm_ffn1")),
        "ffn1": _ffn_to_jax(s.sub("ffn1")),
        "LayerNorm_1": _ln_to_jax(s.sub("norm_mha")),
        "mha": mha,
        "conv": _conv_module_to_jax(s.sub("conv")),
        "LayerNorm_2": _ln_to_jax(s.sub("norm_ffn2")),
        "ffn2": _ffn_to_jax(s.sub("ffn2")),
        "LayerNorm_3": _ln_to_jax(s.sub("norm_out")),
    }


def _decoder_layer_to_jax(s):
    def attn(name):
        return {n: _dense_to_jax(s.sub(f"{name}.{n}"))
                for n in ("q_proj", "k_proj", "v_proj", "out_proj")}

    return {
        "self_attn": attn("self_attn"),
        "cross_attn": attn("cross_attn"),
        "LayerNorm_0": _ln_to_jax(s.sub("norm1")),
        "LayerNorm_1": _ln_to_jax(s.sub("norm2")),
        "LayerNorm_2": _ln_to_jax(s.sub("norm3")),
        "PositionalwiseFeedForward_0": _ffn_to_jax(s.sub("ffn")),
    }


def _encoder_layer_to_jax(s):
    a = s.sub("self_attn")
    if "pos_bias_u" in a:
        attn = {n: _dense_to_jax(a.sub(n)) for n in
                ("q_proj", "k_proj", "v_proj", "pos_proj", "out_proj")}
        attn["pos_bias_u"] = _a(a["pos_bias_u"])
        attn["pos_bias_v"] = _a(a["pos_bias_v"])
        name = "RelPosMHAXL_0"
    else:
        attn = {n: _dense_to_jax(a.sub(n))
                for n in ("q_proj", "k_proj", "v_proj", "out_proj")}
        name = "MultiheadAttention_0"
    return {
        name: attn,
        "LayerNorm_0": _ln_to_jax(s.sub("norm1")),
        "LayerNorm_1": _ln_to_jax(s.sub("norm2")),
        "PositionalwiseFeedForward_0": _ffn_to_jax(s.sub("ffn")),
    }


def to_jax_transformer_lm(state_dict, prefix=""):
    """The port's ``TransformerLM`` state_dict -> JAX params."""
    s = _Sub(state_dict, prefix)
    enc = s.sub("encoder")
    denses = [_dense_to_jax(s.sub("output_proj"))]
    if "emb_proj.weight" in s:
        denses.insert(0, _dense_to_jax(s.sub("emb_proj")))
    return {
        "NormalizedEmbedding_0": {"Embed_0": {"embedding": _a(s["emb.emb.weight"])}},
        **{f"Dense_{i}": d for i, d in enumerate(denses)},
        "TransformerEncoder_0": {
            **{f"layer_{i}": _encoder_layer_to_jax(enc.sub(f"layers.{i}"))
               for i in range(enc.count("layers"))},
            "norm_out": _ln_to_jax(enc.sub("norm_out")),
        },
    }


def to_jax_transformer_asr(state_dict, prefix=""):
    """TransformerASR state_dict (entries under ``prefix``; conformer or
    transformer encoder: a conformer layer holds ``norm_ffn1``) -> JAX
    params."""
    s = _Sub(state_dict, prefix)
    enc, dec = s.sub("encoder"), s.sub("decoder")

    def layer(i):
        sub = enc.sub(f"layers.{i}")
        if "norm_ffn1.weight" in sub:
            return _conformer_layer_to_jax(sub)
        return _encoder_layer_to_jax(sub)

    out = {
        "custom_src_module": _dense_to_jax(s.sub("custom_src_module")),
        "encoder": {
            **{f"layer_{i}": layer(i) for i in range(enc.count("layers"))},
            "norm_out": _ln_to_jax(enc.sub("norm_out")),
        },
    }
    if "custom_tgt_module.emb.weight" in s:
        out["custom_tgt_module"] = {
            "Embed_0": {"embedding": _a(s["custom_tgt_module.emb.weight"])}}
    if "norm_out.weight" in dec:
        out["decoder"] = {
            **{f"layer_{i}": _decoder_layer_to_jax(dec.sub(f"layers.{i}"))
               for i in range(dec.count("layers"))},
            "norm_out": _ln_to_jax(dec.sub("norm_out")),
        }
    return out


def to_jax_frontend(state_dict, prefix=""):
    """ConvolutionFrontEnd state_dict -> {"params", "batch_stats"}."""
    s = _Sub(state_dict, prefix)
    params, stats = {}, {}
    for i in range(s.count("convs")):
        c = s.sub(f"convs.{i}")
        params[f"Conv2d_{i}"] = {"Conv_0": {
            "kernel": _a(c["weight"]).transpose(2, 3, 1, 0).copy(),
            "bias": _a(c["bias"])}}
    for i in range(s.count("norms")):
        n = s.sub(f"norms.{i}")
        params[f"BatchNorm1d_{i}"] = {"BatchNorm_0": {
            "scale": _a(n["weight"]), "bias": _a(n["bias"])}}
        stats[f"BatchNorm1d_{i}"] = {"BatchNorm_0": {
            "mean": _a(n["running_mean"]), "var": _a(n["running_var"])}}
    return {"params": params, "batch_stats": stats}


def to_jax_conformer_asr(state_dict):
    """``asr.ConformerASR`` (or ``ConformerASRBrain.modules``) state_dict
    -> the JAX pieces ``conformer_asr_state_dict`` takes:
    ``{"frontend": variables, "transformer": params, "ctc_lin": params,
    "seq_lin": params, "norm": GlobalNormState}``."""
    s = _Sub(state_dict)
    return {
        "frontend": to_jax_frontend(state_dict, "frontend."),
        "transformer": to_jax_transformer_asr(state_dict, "transformer."),
        "ctc_lin": {"Dense_0": _dense_to_jax(s.sub("ctc_lin"))},
        "seq_lin": {"Dense_0": _dense_to_jax(s.sub("seq_lin"))},
        "norm": {k: _a(s[f"normalize.{k}"]) for k in ("count", "mean", "std")},
    }


def to_jax_gru(state_dict, prefix=""):
    """The port's ``GRU``, ``LSTM`` or ``RNN`` state_dict -> JAX params
    (also ``to_jax_lstm``/``to_jax_rnn``): the GRU (``weight_hh`` (3H,
    H)) keeps its ``bias_hh`` as ``l{i}_u_bias``; the LSTM's and the
    RNN's zero ``bias_hh`` has no JAX counterpart."""
    s = _Sub(state_dict, prefix)
    p = {}
    for i in range(s.count("rnns")):
        r = s.sub(f"rnns.{i}")
        for name, suffix in ((f"l{i}", ""), (f"l{i}_bwd", "_reverse")):
            if f"weight_ih_l0{suffix}" not in r:
                continue
            u = _a(r[f"weight_hh_l0{suffix}"])
            p[f"{name}_wx"] = {"kernel": _a(r[f"weight_ih_l0{suffix}"]).T.copy(),
                               "bias": _a(r[f"bias_ih_l0{suffix}"])}
            p[f"{name}_u"] = u.T.copy()
            if u.shape[0] == 3 * u.shape[1]:
                p[f"{name}_u_bias"] = _a(r[f"bias_hh_l0{suffix}"])
    return p


to_jax_lstm = to_jax_rnn = to_jax_gru


def to_jax_conformer_transducer(state_dict):
    """``asr.ConformerTransducer`` (or ``ConformerTransducerBrain.modules``)
    state_dict -> the JAX pieces ``conformer_transducer_state_dict``
    takes: ``{"frontend", "transformer", "enc_lin", "emb", "dec",
    "dec_lin", "out_lin", "norm"}``."""
    s = _Sub(state_dict)
    emb = ({"Embed_0": {"embedding": _a(s["emb.weight"])}}
           if "emb.weight" in s else {})
    return {
        "frontend": to_jax_frontend(state_dict, "frontend."),
        "transformer": to_jax_transformer_asr(state_dict, "transformer."),
        **{name: {"Dense_0": _dense_to_jax(s.sub(name))}
           for name in ("enc_lin", "dec_lin", "out_lin")},
        "emb": emb,
        "dec": to_jax_gru(state_dict, "dec."),
        "norm": {k: _a(s[f"normalize.{k}"]) for k in ("count", "mean", "std")},
    }


def _bn_to_jax(s):
    return ({"scale": _a(s["weight"]), "bias": _a(s["bias"])},
            {"mean": _a(s["running_mean"]), "var": _a(s["running_var"])})


def to_jax_ligru(state_dict, prefix=""):
    """The port's ``LiGRU`` state_dict -> JAX ``(params, batch_stats)``."""
    s = _Sub(state_dict, prefix)
    params, stats = {}, {}
    for i in range(s.count("layers")):
        layer = s.sub(f"layers.{i}")
        params[f"l{i}_wx"] = {"kernel": _a(layer["wx.weight"]).T.copy()}
        params[f"l{i}_bn"], stats[f"l{i}_bn"] = _bn_to_jax(layer.sub("bn"))
        params[f"l{i}_u"] = _a(layer["weight_hh"]).T.copy()
    return params, stats


def to_jax_crdnn(state_dict, prefix=""):
    """The port's ``CRDNN`` state_dict -> JAX ``{"params",
    "batch_stats"}``."""
    s = _Sub(state_dict, prefix)
    params, stats = {}, {}
    for i in range(s.count("cnn")):
        block = s.sub(f"cnn.{i}")
        p = {}
        for j in range(block.count("convs")):
            c = block.sub(f"convs.{j}")
            p[f"Conv2d_{j}"] = {"Conv_0": {
                "kernel": _a(c["weight"]).transpose(2, 3, 1, 0).copy(),
                "bias": _a(c["bias"])}}
        for j in range(block.count("norms")):
            p[f"LayerNorm_{j}"] = {"LayerNorm_0": _ln_to_jax(
                block.sub(f"norms.{j}"))}
        params[f"cnn_{i}"] = p
    if "proj.weight" in s:
        params["Dense_0"] = _dense_to_jax(s.sub("proj"))
    if "rnn.layers.0.weight_hh" in s:
        params["rnn"], stats["rnn"] = to_jax_ligru(state_dict, prefix + "rnn.")
    else:
        params["rnn"] = to_jax_gru(state_dict, prefix + "rnn.")
    for i in range(s.count("dnn")):
        block = s.sub(f"dnn.{i}")
        bn, st = _bn_to_jax(block.sub("norm"))
        params[f"dnn_{i}"] = {"Dense_0": _dense_to_jax(block.sub("linear")),
                              "BatchNorm1d_0": {"BatchNorm_0": bn}}
        stats[f"dnn_{i}"] = {"BatchNorm1d_0": {"BatchNorm_0": st}}
    return {"params": params, "batch_stats": stats}


def to_jax_crdnn_transducer(state_dict):
    """``asr.CRDNNTransducer`` (or ``CRDNNTransducerBrain.modules``)
    state_dict -> the JAX pieces ``crdnn_transducer_state_dict`` takes:
    ``{"enc", "enc_lin", "emb", "dec", "dec_lin", "out_lin", "norm"}``."""
    s = _Sub(state_dict)
    emb = ({"Embed_0": {"embedding": _a(s["emb.weight"])}}
           if "emb.weight" in s else {})
    return {
        "enc": to_jax_crdnn(state_dict, "enc."),
        **{name: {"Dense_0": _dense_to_jax(s.sub(name))}
           for name in ("enc_lin", "dec_lin", "out_lin")},
        "emb": emb,
        "dec": to_jax_gru(state_dict, "dec."),
        "norm": {k: _a(s[f"normalize.{k}"]) for k in ("count", "mean", "std")},
    }


def _bn_pair_to_jax(s):
    p, st = _bn_to_jax(s)
    return {"BatchNorm_0": p}, {"BatchNorm_0": st}


def _conv1d_to_jax(s):
    p = {"kernel": _a(s["weight"]).transpose(2, 1, 0).copy()}
    if "bias" in s:
        p["bias"] = _a(s["bias"])
    return p


def to_jax_xvector(state_dict, prefix=""):
    """The port's ``Xvector`` state_dict -> JAX ``{"params",
    "batch_stats"}``."""
    s = _Sub(state_dict, prefix)
    params, stats = {}, {}
    for i in range(s.count("blocks")):
        block = s.sub(f"blocks.{i}")
        params[f"Conv1d_{i}"] = {"Conv_0": _conv1d_to_jax(block.sub("conv"))}
        params[f"BatchNorm1d_{i}"], stats[f"BatchNorm1d_{i}"] = (
            _bn_pair_to_jax(block.sub("norm")))
    params["Dense_0"] = _dense_to_jax(s.sub("lin"))
    return {"params": params, "batch_stats": stats}


def to_jax_classifier(state_dict, prefix=""):
    """The port's ``Classifier`` state_dict -> JAX ``{"params",
    "batch_stats"}``."""
    s = _Sub(state_dict, prefix)
    params, stats = {}, {}
    n_blocks = s.count("blocks")
    for i in range(n_blocks):
        block = s.sub(f"blocks.{i}")
        params[f"Dense_{i}"] = _dense_to_jax(block.sub("linear"))
        params[f"BatchNorm1d_{i}"], stats[f"BatchNorm1d_{i}"] = (
            _bn_pair_to_jax(block.sub("norm")))
    if "centroids" in s:
        params["centroids"] = _a(s["centroids"])
    else:
        params[f"Dense_{n_blocks}"] = _dense_to_jax(s.sub("out"))
    return {"params": params, "batch_stats": stats}


def _tdnn_block_to_jax(s):
    bn, st = _bn_pair_to_jax(s.sub("norm"))
    return ({"Conv1d_0": {"Conv_0": _conv1d_to_jax(s.sub("conv"))},
             "BatchNorm1d_0": bn}, {"BatchNorm1d_0": st})


def _seres2net_to_jax(s, names, params, stats):
    """The inverse of ``_seres2net``: fills ``params``/``stats`` under
    the JAX names."""
    for port in ("tdnn1", "tdnn2"):
        params[names[port]], stats[names[port]] = _tdnn_block_to_jax(
            s.sub(port))
    res2, res2_st = {}, {}
    for i in range(s.sub("res2net").count("blocks")):
        res2[f"block_{i + 1}"], res2_st[f"block_{i + 1}"] = (
            _tdnn_block_to_jax(s.sub(f"res2net.blocks.{i}")))
    params[names["res2net"]], stats[names["res2net"]] = res2, res2_st
    params[names["se"]] = {
        "Conv1d_0": {"Conv_0": _conv1d_to_jax(s.sub("se.conv1"))},
        "Conv1d_1": {"Conv_0": _conv1d_to_jax(s.sub("se.conv2"))}}
    if "shortcut.weight" in s:
        params["shortcut"] = _conv1d_to_jax(s.sub("shortcut"))


def to_jax_seres2net(state_dict, prefix=""):
    """The port's ``SERes2NetBlock`` state_dict -> JAX ``{"params",
    "batch_stats"}``."""
    params, stats = {}, {}
    _seres2net_to_jax(_Sub(state_dict, prefix), _SERES2NET_NAMES, params,
                      stats)
    return {"params": params, "batch_stats": stats}


def to_jax_ecapa(state_dict, prefix=""):
    """The port's ``ECAPA_TDNN`` state_dict -> JAX ``{"params",
    "batch_stats"}``."""
    s = _Sub(state_dict, prefix)
    params, stats = {}, {}
    params["block_0"], stats["block_0"] = _tdnn_block_to_jax(s.sub("blocks.0"))
    for i in range(1, s.count("blocks")):
        names = {"tdnn1": f"serez_{i}_in", "res2net": f"serez_{i}_res2",
                 "tdnn2": f"serez_{i}_out", "se": f"serez_{i}_se"}
        _seres2net_to_jax(s.sub(f"blocks.{i}"), names, params, stats)
    params["mfa"], stats["mfa"] = _tdnn_block_to_jax(s.sub("mfa"))
    tdnn, tdnn_st = _tdnn_block_to_jax(s.sub("asp.tdnn"))
    params["asp"] = {"TDNNBlock_0": tdnn,
                     "Conv1d_0": {"Conv_0": _conv1d_to_jax(s.sub("asp.conv"))}}
    stats["asp"] = {"TDNNBlock_0": tdnn_st}
    params["asp_bn"], stats["asp_bn"] = _bn_pair_to_jax(s.sub("asp_bn"))
    params["fc"] = {"Conv_0": _conv1d_to_jax(s.sub("fc"))}
    return {"params": params, "batch_stats": stats}


def to_jax_ecapa_classifier(state_dict, prefix=""):
    """The port's ``ECAPA_TDNN.Classifier`` state_dict -> JAX
    ``{"params"[, "batch_stats"]}`` (``batch_stats`` when it has
    ``lin_blocks``)."""
    s = _Sub(state_dict, prefix)
    params, stats = {"weight": _a(s["weight"])}, {}
    for i in range(s.count("blocks")):
        block = s.sub(f"blocks.{i}")
        params[f"Dense_{i}"] = _dense_to_jax(block.sub("linear"))
        params[f"BatchNorm1d_{i}"], stats[f"BatchNorm1d_{i}"] = (
            _bn_pair_to_jax(block.sub("norm")))
    return {"params": params, **({"batch_stats": stats} if stats else {})}


# ------------------------------------------------------------------
# separation models, both ways


def conv_transpose1d(p):
    """Flax ConvTranspose {kernel (k, in, out)[, bias]} -> ``ConvTranspose1d``
    {weight (in, out, k), taps reversed[, bias]}."""
    kern = np.asarray(p["kernel"])[::-1].transpose(1, 2, 0)
    sd = {"weight": _t(kern).contiguous()}
    if "bias" in p:
        sd["bias"] = _t(p["bias"])
    return sd


def to_jax_conv_transpose1d(state_dict, prefix=""):
    """The inverse of ``conv_transpose1d``."""
    s = _Sub(state_dict, prefix)
    p = {"kernel": _a(s["weight"]).transpose(2, 0, 1)[::-1].copy()}
    if "bias" in s:
        p["bias"] = _a(s["bias"])
    return p


def _pointwise(p):
    """A 1x1 Flax Conv {kernel (1, in, out)[, bias]} -> ``Linear``."""
    return dense({**p, "kernel": np.asarray(p["kernel"])[0]})


def _pointwise_to_jax(s):
    p = _dense_to_jax(s)
    p["kernel"] = p["kernel"][None]
    return p


def _encoder_stack(p):
    """A TransformerEncoder's or ConformerEncoder's ``layer_{i}`` and
    ``norm_out`` -> ``layers.{i}`` and ``norm_out``."""
    layer = conformer_layer if "ffn1" in p["layer_0"] else encoder_layer
    sd = {}
    for i, lp in enumerate(_numbered(p, "layer_")):
        sd.update(_prefixed(f"layers.{i}", layer(lp)))
    sd.update(_prefixed("norm_out", layer_norm(p["norm_out"])))
    return sd


def _encoder_stack_to_jax(s):
    layer = (_conformer_layer_to_jax if "layers.0.ffn1.w_1.weight" in s
             else _encoder_layer_to_jax)
    return {**{f"layer_{i}": layer(s.sub(f"layers.{i}"))
               for i in range(s.count("layers"))},
            "norm_out": _ln_to_jax(s.sub("norm_out"))}


def _slope(p):
    return {"weight": _t(p["negative_slope"])}


def _dual_path(dp):
    """JAX ``Dual_Path_Model`` params -> the port's ``Dual_Path_Model``
    state_dict."""
    sd = {**_prefixed("norm", layer_norm(dp["LayerNorm_0"])),
          **_prefixed("conv1d", _pointwise(dp["Conv1d_0"]["Conv_0"]))}
    for layer in range(len(_numbered(dp, "intra_"))):
        for kind in ("intra", "inter"):
            block = dp[f"{kind}_{layer}"]
            sd.update(_prefixed(f"{kind}.{layer}.mdl", (
                lstm(block["LSTM_0"]) if "LSTM_0" in block else
                _encoder_stack(block.get("TransformerEncoder_0",
                                         block.get("encoder"))))))
        sd.update(_prefixed(f"intra_norm.{layer}",
                            layer_norm(dp[f"LayerNorm_{2 * layer + 1}"])))
        sd.update(_prefixed(f"inter_norm.{layer}",
                            layer_norm(dp[f"LayerNorm_{2 * layer + 2}"])))
    sd.update(_prefixed("prelu", _slope(dp["PReLU_0"])))
    sd.update(_prefixed("conv_out", _pointwise(dp["Conv1d_1"]["Conv_0"])))
    return sd


def sepformer_state_dict(params):
    """JAX ``SepformerWrapper`` params (transformer, conformer or RNN
    blocks) -> the port's ``SepformerWrapper`` state_dict."""
    return {
        **_prefixed("encoder.conv",
                    conv1d(params["Encoder_0"]["Conv1d_0"]["Conv_0"])),
        **_prefixed("masknet", _dual_path(params["Dual_Path_Model_0"])),
        **_prefixed("decoder.conv", conv_transpose1d(
            params["Decoder_0"]["ConvTranspose1d_0"]["ConvTranspose_0"])),
    }


def to_jax_sepformer(state_dict, prefix=""):
    """The port's ``SepformerWrapper`` state_dict -> JAX params."""
    s = _Sub(state_dict, prefix)
    m = s.sub("masknet")
    dp = {"LayerNorm_0": _ln_to_jax(m.sub("norm")),
          "Conv1d_0": {"Conv_0": _pointwise_to_jax(m.sub("conv1d"))}}
    for layer in range(m.count("intra")):
        for kind in ("intra", "inter"):
            stack = m.sub(f"{kind}.{layer}.mdl")
            if "rnns.0.weight_ih_l0" in stack:
                dp[f"{kind}_{layer}"] = {"LSTM_0": to_jax_lstm(
                    state_dict, stack.prefix)}
                continue
            name = ("encoder" if "layers.0.ffn1.w_1.weight" in stack
                    else "TransformerEncoder_0")
            dp[f"{kind}_{layer}"] = {name: _encoder_stack_to_jax(stack)}
        dp[f"LayerNorm_{2 * layer + 1}"] = _ln_to_jax(
            m.sub(f"intra_norm.{layer}"))
        dp[f"LayerNorm_{2 * layer + 2}"] = _ln_to_jax(
            m.sub(f"inter_norm.{layer}"))
    dp["PReLU_0"] = {"negative_slope": _a(m["prelu.weight"])}
    dp["Conv1d_1"] = {"Conv_0": _pointwise_to_jax(m.sub("conv_out"))}
    return {
        "Encoder_0": {"Conv1d_0": {"Conv_0": _conv1d_to_jax(
            s.sub("encoder.conv"))}},
        "Dual_Path_Model_0": dp,
        "Decoder_0": {"ConvTranspose1d_0": {
            "ConvTranspose_0": to_jax_conv_transpose1d(
                state_dict, prefix + "decoder.conv.")}},
    }


def _resep_block(b):
    """A JAX pipeline block -> the port's: ``SBTransformerBlock_wnormandskip``
    (``block``, ``norm``), ``SegLSTM`` (``lstm``, ``proj``, ``norm``) or
    ``MemLSTM`` (``{h,c}_net``, ``_proj``, ``_norm``)."""
    if "block" in b:
        sd = _prefixed("block.mdl",
                       _encoder_stack(b["block"]["TransformerEncoder_0"]))
        if "norm" in b:
            sd.update(_prefixed("norm", layer_norm(b["norm"])))
        return sd
    sd = {}
    for net, proj, norm in (("lstm", "proj", "norm"),
                            ("h_net", "h_proj", "h_norm"),
                            ("c_net", "c_proj", "c_norm")):
        if net in b:
            sd.update(_prefixed(net, lstm(b[net])))
            sd.update(_prefixed(proj, dense(b[proj])))
            sd.update(_prefixed(norm, layer_norm(b[norm])))
    return sd


def _resep_block_to_jax(s):
    if "block.mdl.norm_out.weight" in s:
        b = {"block": {"TransformerEncoder_0": _encoder_stack_to_jax(
            s.sub("block.mdl"))}}
        if "norm.weight" in s:
            b["norm"] = _ln_to_jax(s.sub("norm"))
        return b
    b = {}
    for net, proj, norm in (("lstm", "proj", "norm"),
                            ("h_net", "h_proj", "h_norm"),
                            ("c_net", "c_proj", "c_norm")):
        if f"{net}.rnns.0.weight_ih_l0" in s:
            b[net] = to_jax_lstm(s.sd, f"{s.prefix}{net}.")
            b[proj] = _dense_to_jax(s.sub(proj))
            b[norm] = _ln_to_jax(s.sub(norm))
    return b


def _pipeline(p):
    """JAX ``ResourceEfficientSeparationPipeline`` params -> the port's."""
    sd = {}
    for kind in ("seg", "mem"):
        for i, block in enumerate(_numbered(p, f"{kind}_")):
            sd.update(_prefixed(f"{kind}.{i}", _resep_block(block)))
    sd.update(_prefixed("output_fc", dense(p["output_fc"])))
    return sd


def skim_state_dict(params):
    """JAX ``SkiMSeparator`` (or ``ResepformerWrapper``) params -> the
    port's state_dict: ``Encoder_0``/``Decoder_0`` as for the SepFormer,
    ``masknet.pipeline``'s ``seg_{i}``/``mem_{i}`` -> ``seg.{i}``/
    ``mem.{i}``, ``output_fc`` as it is."""
    sd = _prefixed("masknet.pipeline",
                   _pipeline(params["masknet"]["pipeline"]))
    sd.update(_prefixed("encoder.conv",
                        conv1d(params["Encoder_0"]["Conv1d_0"]["Conv_0"])))
    sd.update(_prefixed("decoder.conv", conv_transpose1d(
        params["Decoder_0"]["ConvTranspose1d_0"]["ConvTranspose_0"])))
    return sd


def _codec_to_jax(state_dict, prefix):
    s = _Sub(state_dict, prefix)
    return {
        "Encoder_0": {"Conv1d_0": {"Conv_0": _conv1d_to_jax(
            s.sub("encoder.conv"))}},
        "Decoder_0": {"ConvTranspose1d_0": {
            "ConvTranspose_0": to_jax_conv_transpose1d(
                state_dict, prefix + "decoder.conv.")}},
    }


def to_jax_skim(state_dict, prefix=""):
    """The port's ``SkiMSeparator`` state_dict -> JAX params."""
    s = _Sub(state_dict, prefix).sub("masknet.pipeline")
    pipe = {}
    for kind in ("seg", "mem"):
        for i in range(s.count(kind)):
            pipe[f"{kind}_{i}"] = _resep_block_to_jax(s.sub(f"{kind}.{i}"))
    pipe["output_fc"] = _dense_to_jax(s.sub("output_fc"))
    return {**_codec_to_jax(state_dict, prefix),
            "masknet": {"pipeline": pipe}}


def resepformer_state_dict(params):
    """JAX ``RESepformer`` params -> the port's state_dict: ``intra_{i}``/
    ``inter_{i}`` (``TransformerEncoder_0``) -> ``intra.{i}.mdl``/
    ``inter.{i}.mdl``, the 1x1 ``mask_out`` -> ``mask_out``."""
    sd = {}
    for kind in ("intra", "inter"):
        for i, block in enumerate(_numbered(params, f"{kind}_")):
            sd.update(_prefixed(f"{kind}.{i}.mdl", _encoder_stack(
                block["TransformerEncoder_0"])))
    sd.update(_prefixed("mask_out", _pointwise(params["mask_out"]["Conv_0"])))
    sd.update(_prefixed("encoder.conv",
                        conv1d(params["Encoder_0"]["Conv1d_0"]["Conv_0"])))
    sd.update(_prefixed("decoder.conv", conv_transpose1d(
        params["Decoder_0"]["ConvTranspose1d_0"]["ConvTranspose_0"])))
    return sd


def to_jax_resepformer(state_dict, prefix=""):
    """The port's ``RESepformer`` state_dict -> JAX params."""
    s = _Sub(state_dict, prefix)
    p = _codec_to_jax(state_dict, prefix)
    for kind in ("intra", "inter"):
        for i in range(s.count(kind)):
            p[f"{kind}_{i}"] = {"TransformerEncoder_0": _encoder_stack_to_jax(
                s.sub(f"{kind}.{i}.mdl"))}
    p["mask_out"] = {"Conv_0": _pointwise_to_jax(s.sub("mask_out"))}
    return p


def _tasnet_norm(p):
    """A gLN/cLN {gamma, beta} or a LayerNorm {scale, bias}."""
    if "gamma" in p:
        return {"weight": _t(p["gamma"]), "bias": _t(p["beta"])}
    return layer_norm(p)


def _tasnet_norm_to_jax(s, kind):
    if kind == "LayerNorm":
        return _ln_to_jax(s)
    return {"gamma": _a(s["weight"]), "beta": _a(s["bias"])}


def _dsconv(ds):
    """JAX ``DepthwiseSeparableConv`` params -> the port's."""
    return {**_prefixed("depthwise", conv1d(ds["conv_0"]["Conv_0"])),
            **_prefixed("act", _slope(ds["act"])),
            **_prefixed("norm", _tasnet_norm(ds["norm"])),
            **_prefixed("pointwise", _pointwise(ds["conv_1"]["Conv_0"]))}


def _temporal_block(b):
    """JAX ``TemporalBlock`` params -> the port's."""
    return {**_prefixed("conv", _pointwise(b["conv"]["Conv_0"])),
            **_prefixed("act", _slope(b["act"])),
            **_prefixed("norm", _tasnet_norm(b["norm"])),
            **_prefixed("dsconv", _dsconv(b["DSconv"]))}


def _temporal_blocks(tcn):
    """JAX ``TemporalBlocksSequential`` params (``temporalblock_{r}_{i}``)
    -> the port's (``{r X + i}``)."""
    names = sorted(tcn, key=lambda k: tuple(int(v) for v in k.split("_")[1:]))
    sd = {}
    for j, name in enumerate(names):
        sd.update(_prefixed(str(j), _temporal_block(tcn[name])))
    return sd


def _masknet(mn):
    """JAX Conv-TasNet ``MaskNet`` params -> the port's."""
    return {
        **_prefixed("layer_norm", _tasnet_norm(mn["layer_norm"])),
        **_prefixed("bottleneck", _pointwise(mn["bottleneck_conv1x1"]["Conv_0"])),
        **_prefixed("temporal_conv_net", _temporal_blocks(mn["temporal_conv_net"])),
        **_prefixed("mask_conv", _pointwise(mn["mask_conv1x1"]["Conv_0"])),
    }


def convtasnet_state_dict(params):
    """JAX ``ConvTasNet`` params -> the port's ``ConvTasNet``
    state_dict."""
    return {
        **_prefixed("encoder.conv",
                    conv1d(params["Encoder_0"]["conv1d_U"]["Conv_0"])),
        **_prefixed("masknet", _masknet(params["MaskNet_0"])),
        **_prefixed("decoder.basis",
                    dense(params["Decoder_0"]["basis_signals"]["Dense_0"])),
    }


def to_jax_convtasnet(state_dict, X, norm_type="gLN", prefix=""):
    """The port's ``ConvTasNet`` state_dict -> JAX params; ``X`` (blocks
    a repeat) names the temporal blocks, ``norm_type`` the blocks' norms'
    parameters ("gLN"/"cLN": ``gamma``/``beta``; else a LayerNorm's)."""
    s = _Sub(state_dict, prefix)
    return {
        "Encoder_0": {"conv1d_U": {"Conv_0": _conv1d_to_jax(
            s.sub("encoder.conv"))}},
        "MaskNet_0": _masknet_to_jax(s.sub("masknet"), X, norm_type),
        "Decoder_0": {"basis_signals": {"Dense_0": _dense_to_jax(
            s.sub("decoder.basis"))}},
    }


def _masknet_to_jax(m, X, norm_type):
    """The port's Conv-TasNet ``MaskNet`` (under ``m``) -> JAX params."""
    kind = "LayerNorm" if norm_type not in ("gLN", "cLN") else "gln"
    tcn = {}
    for j in range(m.count("temporal_conv_net")):
        b = m.sub(f"temporal_conv_net.{j}")
        tcn[f"temporalblock_{j // X}_{j % X}"] = {
            "conv": {"Conv_0": _pointwise_to_jax(b.sub("conv"))},
            "act": {"negative_slope": _a(b["act.weight"])},
            "norm": _tasnet_norm_to_jax(b.sub("norm"), kind),
            "DSconv": {
                "conv_0": {"Conv_0": _conv1d_to_jax(b.sub("dsconv.depthwise"))},
                "act": {"negative_slope": _a(b["dsconv.act.weight"])},
                "norm": _tasnet_norm_to_jax(b.sub("dsconv.norm"), kind),
                "conv_1": {"Conv_0": _pointwise_to_jax(
                    b.sub("dsconv.pointwise"))}}}
    return {
        "layer_norm": _tasnet_norm_to_jax(m.sub("layer_norm"), "gln"),
        "bottleneck_conv1x1": {"Conv_0": _pointwise_to_jax(
            m.sub("bottleneck"))},
        "temporal_conv_net": tcn,
        "mask_conv1x1": {"Conv_0": _pointwise_to_jax(m.sub("mask_conv"))},
    }


def binaural_convtasnet_state_dict(params):
    """JAX ``BinauralConvTasNet`` params (any mode) -> the port's:
    ``encoder_{l,r}.conv1d_U`` -> ``encoder_{l,r}.conv``,
    ``masknet_{l,r}`` as ``MaskNet_0`` is for ``ConvTasNet``,
    ``decoder_{l,r}.basis_signals`` -> ``decoder_{l,r}.basis``, and in
    the "cross" mode ``ild_proj`` as it is."""
    sd = {}
    for ear in ("l", "r"):
        sd.update(_prefixed(f"encoder_{ear}.conv", conv1d(
            params[f"encoder_{ear}"]["conv1d_U"]["Conv_0"])))
        sd.update(_prefixed(f"masknet_{ear}", _masknet(params[f"masknet_{ear}"])))
        sd.update(_prefixed(f"decoder_{ear}.basis", dense(
            params[f"decoder_{ear}"]["basis_signals"]["Dense_0"])))
    if "ild_proj" in params:
        sd.update(_prefixed("ild_proj", dense(params["ild_proj"])))
    return sd


def to_jax_binaural_convtasnet(state_dict, X, norm_type="gLN", prefix=""):
    """The port's ``BinauralConvTasNet`` state_dict -> JAX params (``X``
    and ``norm_type`` as for ``to_jax_convtasnet``)."""
    s = _Sub(state_dict, prefix)
    p = {}
    for ear in ("l", "r"):
        p[f"encoder_{ear}"] = {"conv1d_U": {"Conv_0": _conv1d_to_jax(
            s.sub(f"encoder_{ear}.conv"))}}
        p[f"masknet_{ear}"] = _masknet_to_jax(s.sub(f"masknet_{ear}"), X,
                                              norm_type)
        p[f"decoder_{ear}"] = {"basis_signals": {"Dense_0": _dense_to_jax(
            s.sub(f"decoder_{ear}.basis"))}}
    if "ild_proj.weight" in s:
        p["ild_proj"] = _dense_to_jax(s.sub("ild_proj"))
    return p


def cnn_transformer_se_state_dict(params):
    """JAX ``CNNTransformerSE`` params -> the port's: ``in_proj`` as it
    is, ``TransformerEncoder_0`` -> ``encoder``, the head ``Dense_0`` ->
    ``output_layer``.

    Example
    -------
    >>> from speechbrain_tpu_torch.lobes.models.transformer.TransformerSE \\
    ...     import CNNTransformerSE
    >>> net = CNNTransformerSE(8, 5, num_layers=1, nhead=2, d_ffn=16)
    >>> p = to_jax_cnn_transformer_se(net.state_dict())
    >>> sorted(p), p["in_proj"]["kernel"].shape
    (['Dense_0', 'TransformerEncoder_0', 'in_proj'], (5, 8))
    >>> sd = cnn_transformer_se_state_dict(p)
    >>> all(torch.equal(sd[k], v) for k, v in net.state_dict().items())
    True
    """
    sd = {**_prefixed("encoder", _encoder_stack(params["TransformerEncoder_0"])),
          **_prefixed("output_layer", dense(params["Dense_0"]))}
    if "in_proj" in params:
        sd.update(_prefixed("in_proj", dense(params["in_proj"])))
    return sd


def to_jax_cnn_transformer_se(state_dict, prefix=""):
    """The port's ``CNNTransformerSE`` state_dict -> JAX params."""
    s = _Sub(state_dict, prefix)
    p = {"TransformerEncoder_0": _encoder_stack_to_jax(s.sub("encoder")),
         "Dense_0": _dense_to_jax(s.sub("output_layer"))}
    if "in_proj.weight" in s:
        p["in_proj"] = _dense_to_jax(s.sub("in_proj"))
    return p


def spectral_mask_state_dict(params):
    """JAX ``SpectralMaskWrapper`` params over a ``CNNTransformerSE`` ->
    the port's (``masker.*``)."""
    return _prefixed("masker", cnn_transformer_se_state_dict(params["masker"]))


def to_jax_spectral_mask(state_dict, prefix=""):
    """The port's ``SpectralMaskWrapper`` state_dict -> JAX params."""
    return {"masker": to_jax_cnn_transformer_se(state_dict, prefix + "masker.")}


def pytorch_transformer_block_state_dict(params):
    """JAX ``PytorchTransformerBlock`` params -> the port's: its
    ``encoder`` (a ``TransformerEncoder``) keeps its name; the positional
    encoding has no weights."""
    return _prefixed("encoder", _encoder_stack(params["encoder"]))


def to_jax_pytorch_transformer_block(state_dict, prefix=""):
    """The port's ``PytorchTransformerBlock`` state_dict -> JAX params."""
    return {"encoder": _encoder_stack_to_jax(
        _Sub(state_dict, prefix).sub("encoder"))}


def dptnet_block_state_dict(params):
    """JAX ``DPTNetBlock`` params -> the port's: ``mha`` (q/k/v/out
    projections), ``norm1``/``norm2``, the GRU ``rnn_ffn`` and the Dense
    ``ffn_out`` keep their names."""
    return {**_prefixed("mha", mha(params["mha"])),
            **_prefixed("norm1", layer_norm(params["norm1"])),
            **_prefixed("rnn_ffn", gru(params["rnn_ffn"])),
            **_prefixed("ffn_out", dense(params["ffn_out"])),
            **_prefixed("norm2", layer_norm(params["norm2"]))}


def to_jax_dptnet_block(state_dict, prefix=""):
    """The port's ``DPTNetBlock`` state_dict -> JAX params."""
    s = _Sub(state_dict, prefix)
    return {"mha": {n: _dense_to_jax(s.sub(f"mha.{n}"))
                    for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "norm1": _ln_to_jax(s.sub("norm1")),
            "rnn_ffn": to_jax_gru(state_dict, prefix + "rnn_ffn."),
            "ffn_out": _dense_to_jax(s.sub("ffn_out")),
            "norm2": _ln_to_jax(s.sub("norm2"))}


def dual_computation_block_state_dict(params):
    """JAX ``Dual_Computation_Block`` params -> the port's: ``intra_mdl``/
    ``inter_mdl`` (an ``SBTransformerBlock``'s ``TransformerEncoder_0``
    -> ``{intra,inter}_mdl.mdl``), ``intra_lin``/``inter_lin`` and
    ``intra_norm``/``inter_norm`` where present."""
    sd = {}
    for kind in ("intra", "inter"):
        sd.update(_prefixed(f"{kind}_mdl.mdl", _encoder_stack(
            params[f"{kind}_mdl"]["TransformerEncoder_0"])))
        if f"{kind}_lin" in params:
            sd.update(_prefixed(f"{kind}_lin", dense(params[f"{kind}_lin"])))
        if f"{kind}_norm" in params:
            sd.update(_prefixed(f"{kind}_norm",
                                layer_norm(params[f"{kind}_norm"])))
    return sd


def to_jax_dual_computation_block(state_dict, prefix=""):
    """The port's ``Dual_Computation_Block`` state_dict -> JAX params."""
    s = _Sub(state_dict, prefix)
    p = {}
    for kind in ("intra", "inter"):
        p[f"{kind}_mdl"] = {"TransformerEncoder_0": _encoder_stack_to_jax(
            s.sub(f"{kind}_mdl.mdl"))}
        if f"{kind}_lin.weight" in s:
            p[f"{kind}_lin"] = _dense_to_jax(s.sub(f"{kind}_lin"))
        if f"{kind}_norm.weight" in s:
            p[f"{kind}_norm"] = _ln_to_jax(s.sub(f"{kind}_norm"))
    return p


def rnn_cell(p):
    """JAX ``GRUCell``/``LSTMCell``/``RNNCell`` params -> the port's cell
    state_dict (``wx.{i}``, ``u.{i}``)."""
    sd = {}
    for i in range(len([k for k in p if k.endswith("_wx")])):
        sd.update(_prefixed(f"wx.{i}", dense(p[f"l{i}_wx"])))
        sd.update(_prefixed(f"u.{i}", dense(p[f"l{i}_u"])))
    return sd


def to_jax_rnn_cell(state_dict, prefix=""):
    """The port's cell state_dict -> JAX cell params."""
    s = _Sub(state_dict, prefix)
    p = {}
    for i in range(s.count("wx")):
        p[f"l{i}_wx"] = _dense_to_jax(s.sub(f"wx.{i}"))
        p[f"l{i}_u"] = _dense_to_jax(s.sub(f"u.{i}"))
    return p


_RNN_ATTENTION_DENSES = ("mlp_enc", "mlp_dec", "mlp_loc", "mlp_attn",
                         "mlp_out", "key_linear", "query_linear",
                         "value_linear")


def rnn_attention(p):
    """JAX ``ContentBasedAttention``/``LocationAwareAttention``/
    ``KeyValueAttention`` params -> the port's state_dict."""
    sd = {}
    for name in _RNN_ATTENTION_DENSES:
        if name in p:
            sd.update(_prefixed(name, dense(p[name])))
    if "conv_loc" in p:
        kern = np.asarray(p["conv_loc"]["kernel"])  # (K, 1, C)
        sd["conv_loc.weight"] = _t(kern.transpose(2, 1, 0)).contiguous()
    return sd


def to_jax_rnn_attention(state_dict, prefix=""):
    """The port's RNN attention state_dict -> JAX params."""
    s = _Sub(state_dict, prefix)
    p = {name: _dense_to_jax(s.sub(name)) for name in _RNN_ATTENTION_DENSES
         if f"{name}.weight" in s}
    if "conv_loc.weight" in s:
        p["conv_loc"] = {"kernel": _a(s["conv_loc.weight"]).transpose(2, 1, 0)
                         .copy()}
    return p


def attentional_rnn_decoder(p):
    """JAX ``AttentionalRNNDecoder`` params -> the port's state_dict."""
    return {**_prefixed("rnn", rnn_cell(p["rnn"])),
            **_prefixed("attn", rnn_attention(p["attn"])),
            **_prefixed("proj", dense(p["proj"]))}


def to_jax_attentional_rnn_decoder(state_dict, prefix=""):
    """The port's ``AttentionalRNNDecoder`` state_dict -> JAX params."""
    s = _Sub(state_dict, prefix)
    return {"rnn": to_jax_rnn_cell(state_dict, prefix + "rnn."),
            "attn": to_jax_rnn_attention(state_dict, prefix + "attn."),
            "proj": _dense_to_jax(s.sub("proj"))}


def rnnlm_state_dict(p):
    """JAX ``RNNLM`` params -> the port's ``RNNLM`` state_dict."""
    blocks = len([k for k in p if k.startswith("LayerNorm_")])
    sd = {**_prefixed("emb", embedding(p["Embedding_0"])),
          **_prefixed("rnn", lstm(p["LSTM_0"])),
          **_prefixed("out", dense(p[f"Dense_{blocks}"]))}
    for i in range(blocks):
        sd.update(_prefixed(f"dnn.{i}.linear", dense(p[f"Dense_{i}"])))
        sd.update(_prefixed(f"dnn.{i}.norm",
                            layer_norm(p[f"LayerNorm_{i}"]["LayerNorm_0"])))
    return sd


def to_jax_rnnlm(state_dict, prefix=""):
    """The port's ``RNNLM`` state_dict -> JAX params."""
    s = _Sub(state_dict, prefix)
    blocks = s.count("dnn")
    p = {"Embedding_0": {"Embed_0": {"embedding": _a(s["emb.weight"])}},
         "LSTM_0": to_jax_lstm(state_dict, prefix + "rnn."),
         f"Dense_{blocks}": _dense_to_jax(s.sub("out"))}
    for i in range(blocks):
        p[f"Dense_{i}"] = _dense_to_jax(s.sub(f"dnn.{i}.linear"))
        p[f"LayerNorm_{i}"] = {
            "LayerNorm_0": _ln_to_jax(s.sub(f"dnn.{i}.norm"))}
    return p


def crdnn_seq2seq_state_dict(enc_vars, emb, dec, ctc_lin, seq_lin,
                             norm_state):
    """The modules of the CRDNN seq2seq recipe
    (``recipes/librispeech_seq2seq``), from the JAX recipe's pieces: the
    ``CRDNN``'s ``{"params", "batch_stats"}``, the ``emb`` Embedding, the
    ``dec`` decoder, the ``ctc_lin``/``seq_lin`` Linear params and the
    global input-normalization state."""
    return {
        **_prefixed("normalize", input_norm_state_dict(norm_state)),
        **_prefixed("enc", crdnn_state_dict(enc_vars["params"],
                                            enc_vars["batch_stats"])),
        **_prefixed("emb", embedding(emb)),
        **_prefixed("dec", attentional_rnn_decoder(dec)),
        **_prefixed("ctc_lin", _head(ctc_lin)),
        **_prefixed("seq_lin", _head(seq_lin)),
    }


def to_jax_crdnn_seq2seq(state_dict):
    """The CRDNN seq2seq recipe's modules' state_dict -> the JAX pieces
    ``crdnn_seq2seq_state_dict`` takes: ``{"enc", "emb", "dec",
    "ctc_lin", "seq_lin", "norm"}``."""
    s = _Sub(state_dict)
    return {
        "enc": to_jax_crdnn(state_dict, "enc."),
        "emb": {"Embed_0": {"embedding": _a(s["emb.weight"])}},
        "dec": to_jax_attentional_rnn_decoder(state_dict, "dec."),
        **{name: {"Dense_0": _dense_to_jax(s.sub(name))}
           for name in ("ctc_lin", "seq_lin")},
        "norm": {k: _a(s[f"normalize.{k}"]) for k in ("count", "mean", "std")},
    }


def adamw_state_to_torch(optimizer, names, exp_avg, exp_avg_sq, step):
    """Load Adam moments into ``optimizer`` (a torch ``AdamW`` over one
    parameter group): ``names`` lists the parameters' state_dict names in
    the optimizer's order; ``exp_avg``/``exp_avg_sq`` map those names to
    arrays in the port's layout (optax ``mu``/``nu`` through this
    module's converters); ``step`` is optax's ``count``."""
    sd = optimizer.state_dict()
    sd["state"] = {
        i: {"step": torch.tensor(float(step)),
            "exp_avg": _t(exp_avg[name]).clone(),
            "exp_avg_sq": _t(exp_avg_sq[name]).clone()}
        for i, name in enumerate(names)
    }
    optimizer.load_state_dict(sd)


def adamw_state_from_torch(optimizer, names):
    """The inverse of ``adamw_state_to_torch``: ``(exp_avg, exp_avg_sq,
    step)``, the moments as dicts of float32 numpy arrays keyed by
    ``names`` in the port's layout, and the step as an int."""
    state = optimizer.state_dict()["state"]
    exp_avg = {name: _a(state[i]["exp_avg"]) for i, name in enumerate(names)}
    exp_avg_sq = {name: _a(state[i]["exp_avg_sq"])
                  for i, name in enumerate(names)}
    return exp_avg, exp_avg_sq, int(state[0]["step"])


# ------------------------------------------------------------------
# speech translation: TransformerST and ConformerDecoder


def _embedding_sd(p):
    return {"emb.weight": _t(p["Embed_0"]["embedding"])}


def _stack(p, convert, norm):
    """``layer_{i}`` -> ``layers.{i}`` through ``convert``, and the final
    LayerNorm ``norm`` as it is named."""
    sd = {}
    for i, layer in enumerate(_numbered(p, "layer_")):
        sd.update(_prefixed(f"layers.{i}", convert(layer)))
    sd.update(_prefixed(norm, layer_norm(p[norm])))
    return sd


def transformer_st_state_dict(params):
    """TransformerST params -> the port's ``TransformerST`` state_dict
    (``st`` through ``transformer_asr_state_dict``; the branches the
    params hold)."""
    sd = _prefixed("st", transformer_asr_state_dict(params["st"]))
    if "asr_decoder" in params:
        sd.update(_prefixed("asr_decoder", _stack(
            params["asr_decoder"], decoder_layer, "norm_out")))
        sd.update(_prefixed("custom_asr_tgt_module",
                            _embedding_sd(params["custom_asr_tgt_module"])))
    if "mt_encoder" in params:
        sd.update(_prefixed("mt_encoder", _stack(
            params["mt_encoder"], encoder_layer, "norm_out")))
        sd.update(_prefixed("custom_mt_src_module",
                            _embedding_sd(params["custom_mt_src_module"])))
    return sd


def _conformer_decoder_layer(p):
    att = relpos_mha if "pos_bias_u" in p["mha"] else mha
    return {
        **_prefixed("norm_ffn1", layer_norm(p["LayerNorm_0"])),
        **_prefixed("ffn1", ffn(p["ffn1"])),
        **_prefixed("norm1", layer_norm(p["norm1"])),
        **_prefixed("mha", att(p["mha"])),
        **_prefixed("conv", conv_module(p["conv"])),
        **_prefixed("norm_ffn2", layer_norm(p["LayerNorm_1"])),
        **_prefixed("ffn2", ffn(p["ffn2"])),
        **_prefixed("norm2", layer_norm(p["norm2"])),
    }


def conformer_decoder_state_dict(params):
    """ConformerDecoder params (either attention type) -> state_dict."""
    return _stack(params, _conformer_decoder_layer, "norm")


def _stack_to_jax(s, convert, norm):
    return {**{f"layer_{i}": convert(s.sub(f"layers.{i}"))
               for i in range(s.count("layers"))},
            norm: _ln_to_jax(s.sub(norm))}


def to_jax_transformer_st(state_dict, prefix=""):
    """The port's ``TransformerST`` state_dict -> JAX params."""
    s = _Sub(state_dict, prefix)
    out = {"st": to_jax_transformer_asr(state_dict, prefix + "st.")}
    if "asr_decoder.norm_out.weight" in s:
        out["asr_decoder"] = _stack_to_jax(s.sub("asr_decoder"),
                                           _decoder_layer_to_jax, "norm_out")
        out["custom_asr_tgt_module"] = {"Embed_0": {"embedding": _a(
            s["custom_asr_tgt_module.emb.weight"])}}
    if "mt_encoder.norm_out.weight" in s:
        out["mt_encoder"] = _stack_to_jax(s.sub("mt_encoder"),
                                          _encoder_layer_to_jax, "norm_out")
        out["custom_mt_src_module"] = {"Embed_0": {"embedding": _a(
            s["custom_mt_src_module.emb.weight"])}}
    return out


def _conformer_decoder_layer_to_jax(s):
    a = s.sub("mha")
    names = ("q_proj", "k_proj", "v_proj", "out_proj")
    if "pos_bias_u" in a:
        names += ("pos_proj",)
    att = {n: _dense_to_jax(a.sub(n)) for n in names}
    if "pos_bias_u" in a:
        att["pos_bias_u"] = _a(a["pos_bias_u"])
        att["pos_bias_v"] = _a(a["pos_bias_v"])
    return {
        "LayerNorm_0": _ln_to_jax(s.sub("norm_ffn1")),
        "ffn1": _ffn_to_jax(s.sub("ffn1")),
        "norm1": _ln_to_jax(s.sub("norm1")),
        "mha": att,
        "conv": _conv_module_to_jax(s.sub("conv")),
        "LayerNorm_1": _ln_to_jax(s.sub("norm_ffn2")),
        "ffn2": _ffn_to_jax(s.sub("ffn2")),
        "norm2": _ln_to_jax(s.sub("norm2")),
    }


def to_jax_conformer_decoder(state_dict, prefix=""):
    """The port's ``ConformerDecoder`` state_dict -> JAX params."""
    return _stack_to_jax(_Sub(state_dict, prefix),
                         _conformer_decoder_layer_to_jax, "norm")


ST_HEADS = ("seq_lin", "ctc_lin", "asr_lin")


def speech_translator_state_dict(frontend_vars, transformer_params, heads,
                                 norm_state):
    """Everything ``st.SpeechTranslator`` holds, from the JAX pieces:
    frontend variables, TransformerST params, ``heads`` (a dict of the
    Linear heads' params by name: ``seq_lin`` and those of ``ctc_lin`` and
    ``asr_lin`` the model has) and the global input-normalization state."""
    sd = {
        **_prefixed("normalize", input_norm_state_dict(norm_state)),
        **_prefixed("frontend", frontend_state_dict(frontend_vars)),
        **_prefixed("transformer",
                    transformer_st_state_dict(transformer_params)),
    }
    for name, p in heads.items():
        sd.update(_prefixed(name, _head(p)))
    return sd


def to_jax_speech_translator(state_dict):
    """``st.SpeechTranslator`` (or ``STBrain.modules``) state_dict -> the
    JAX pieces: ``{"frontend": variables, "transformer": params, "norm":
    GlobalNormState}`` and each head the model has (``{"Dense_0":
    params}``) by name."""
    s = _Sub(state_dict)
    out = {
        "frontend": to_jax_frontend(state_dict, "frontend."),
        "transformer": to_jax_transformer_st(state_dict, "transformer."),
        "norm": {k: _a(s[f"normalize.{k}"]) for k in ("count", "mean", "std")},
    }
    for name in ST_HEADS:
        if f"{name}.weight" in s:
            out[name] = {"Dense_0": _dense_to_jax(s.sub(name))}
    return out


# ------------------------------------------------------------------
# wav2vec 2.0 (``lobes/models/wav2vec.py``, ``VanillaNN``)


def w2v_extractor_state_dict(p):
    """W2VLatentExtractor params -> state_dict."""
    sd = {}
    for i, conv in enumerate(_numbered(p, "conv_")):
        kern = np.asarray(conv["kernel"])  # (k, in, out)
        sd[f"convs.{i}.weight"] = _t(kern.transpose(2, 1, 0)).contiguous()
        sd.update(_prefixed(f"norms.{i}", layer_norm(p[f"LayerNorm_{i}"])))
    return sd


def w2v_quantiser_state_dict(p):
    """W2VTargetQuantiser params -> state_dict."""
    vq = p["GumbelVectorQuantizer_0"]
    return {"quantiser.codebook": _t(vq["codebook"]),
            **_prefixed("quantiser.weight_proj", dense(vq["Dense_0"])),
            **_prefixed("proj", dense(p["Dense_0"]))}


def w2v_encoder_state_dict(p):
    """EncoderWrapper params (with or without ``mask_emb``) ->
    state_dict."""
    sd = {**_prefixed("latent_proj", dense(p["Dense_0"])),
          **_prefixed("encoder", _stack(p["TransformerEncoder_0"],
                                        encoder_layer, "norm_out"))}
    if "mask_emb" in p:
        sd["mask_emb"] = _t(p["mask_emb"])
    return sd


def vanilla_nn_state_dict(p):
    """VanillaNN params -> state_dict."""
    sd = {}
    for i, d in enumerate(_numbered(p, "Dense_")):
        sd.update(_prefixed(f"linears.{i}", dense(d)))
    return sd


def _rnn_decoder_or_gru(p):
    """``dec``: an ``AttentionalRNNDecoder`` (the seq2seq and SLU yamls)
    or a ``GRU`` (the transducers' prediction network)."""
    return attentional_rnn_decoder(p) if "attn" in p else gru(p)


def decoder_only_st_state_dict(params):
    """The params of a ``TransformerST`` that only
    ``forward_mt_decoder_only`` ran (Flax made ``st``'s target embedding
    and decoder alone) -> those entries of the port's ``TransformerST``
    state_dict."""
    st = params["st"]
    return {"st.custom_tgt_module.emb.weight": _t(
                st["custom_tgt_module"]["Embed_0"]["embedding"]),
            **_prefixed("st.decoder", _stack(st["decoder"], decoder_layer,
                                             "norm_out"))}


# the wav2vec recipes' modules by name; any other name is a Linear head
_W2V_MODULES = {"extractor": w2v_extractor_state_dict,
                "quantiser": w2v_quantiser_state_dict,
                "encoder": w2v_encoder_state_dict,
                "enc_dnn": vanilla_nn_state_dict,
                "emb": embedding,
                "dec": _rnn_decoder_or_gru,
                "transformer": transformer_asr_state_dict,
                "Transformer": decoder_only_st_state_dict}


def wav2vec_state_dict(params):
    """The wav2vec recipes' params by module name (a JAX Brain's
    ``train_state["params"]``: ``extractor``, ``quantiser``, ``encoder``,
    ``enc_dnn``, ``emb`` (an ``Embedding``), ``dec`` (an
    ``AttentionalRNNDecoder`` or a ``GRU``), ``transformer`` (a
    ``TransformerASR``), ``Transformer`` (a ``TransformerST`` run by
    ``forward_mt_decoder_only``) and the ``Linear`` heads, e.g. ``proj``,
    ``ctc_lin``, ``enc``) -> the state_dict of the port's ``ModuleDict``
    of them (for ``Transformer``, the entries the JAX params hold)."""
    sd = {}
    for name, p in params.items():
        sd.update(_prefixed(name, _W2V_MODULES.get(name, _head)(p)))
    return sd


def _w2v_extractor_to_jax(s):
    out = {}
    for i in range(s.count("convs")):
        w = _a(s[f"convs.{i}.weight"])  # (out, in, k)
        out[f"conv_{i}"] = {"kernel": w.transpose(2, 1, 0).copy()}
        out[f"LayerNorm_{i}"] = _ln_to_jax(s.sub(f"norms.{i}"))
    return out


def _w2v_quantiser_to_jax(s):
    return {"GumbelVectorQuantizer_0": {
                "codebook": _a(s["quantiser.codebook"]),
                "Dense_0": _dense_to_jax(s.sub("quantiser.weight_proj"))},
            "Dense_0": _dense_to_jax(s.sub("proj"))}


def _w2v_encoder_to_jax(s):
    out = {"Dense_0": _dense_to_jax(s.sub("latent_proj")),
           "TransformerEncoder_0": _stack_to_jax(
               s.sub("encoder"), _encoder_layer_to_jax, "norm_out")}
    if "mask_emb" in s:
        out["mask_emb"] = _a(s["mask_emb"])
    return out


def _vanilla_nn_to_jax(s):
    return {f"Dense_{i}": _dense_to_jax(s.sub(f"linears.{i}"))
            for i in range(s.count("linears"))}


def _rnn_decoder_or_gru_to_jax(s):
    if s.count("attn"):
        return to_jax_attentional_rnn_decoder(s.sd, s.prefix)
    return to_jax_gru(s.sd, s.prefix)


def _decoder_only_st_to_jax(s):
    st = s.sub("st")
    return {"st": {
        "custom_tgt_module": {"Embed_0": {"embedding": _a(
            st["custom_tgt_module.emb.weight"])}},
        "decoder": _stack_to_jax(st.sub("decoder"), _decoder_layer_to_jax,
                                 "norm_out")}}


_W2V_TO_JAX = {"extractor": _w2v_extractor_to_jax,
               "quantiser": _w2v_quantiser_to_jax,
               "encoder": _w2v_encoder_to_jax,
               "enc_dnn": _vanilla_nn_to_jax,
               "emb": lambda s: {"Embed_0": {"embedding": _a(s["weight"])}},
               "dec": _rnn_decoder_or_gru_to_jax,
               "transformer": lambda s: to_jax_transformer_asr(s.sd,
                                                               s.prefix),
               "Transformer": _decoder_only_st_to_jax}


def to_jax_wav2vec(state_dict):
    """The inverse of ``wav2vec_state_dict``: a ``ModuleDict`` state_dict
    -> JAX params by module name (a ``Linear`` head as ``{"Dense_0":
    ...}``; of ``Transformer``, what ``forward_mt_decoder_only`` reads)."""
    names = sorted({k.split(".", 1)[0] for k in state_dict})
    out = {}
    for name in names:
        s = _Sub(state_dict, f"{name}.")
        convert = _W2V_TO_JAX.get(name)
        out[name] = (convert(s) if convert is not None
                     else {"Dense_0": _dense_to_jax(s)})
    return out
