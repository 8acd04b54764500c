"""v1 compat — the long tail of the trainer_config_helpers surface.

Covers (reference: python/paddle/trainer_config_helpers/):
- layers.py: projections + operators for mixed_layer, recurrent_group +
  memory + step layers, and the remaining `*_layer` functions;
- activations.py / attrs.py / poolings.py: the full class lists;
- optimizers.py: the remaining optimizer classes;
- evaluators.py: evaluator constructors mapped to the in-program metric
  ops / host-side evaluator classes;
- networks.py: composed networks mapped to the port's nets.

The port's copy of ``paddle_tpu/compat/v1_ext.py``.  Everything here
returns Program Variables (no proto LayerOutput pipeline).  Bad arguments
raise argument errors naming what is missing, as the JAX package's do.
"""

import numpy as np

from .. import layers, nets as _nets, optimizer as _opt, evaluator as _eval
from ..layers import tensor as _tensor
from ..layers.layer_helper import LayerHelper
from ..core import unique_name
from . import v1 as _v1

__all__ = [
    # enums / support classes
    "LayerOutput", "LayerType", "AggregateLevel", "ExpandLevel",
    "layer_support", "StaticInput", "SubsequenceInput", "BaseGeneratedInput",
    "GeneratedInput", "BeamInput",
    # projections / operators
    "full_matrix_projection", "trans_full_matrix_projection",
    "table_projection", "identity_projection", "dotmul_projection",
    "scaling_projection", "context_projection", "conv_projection",
    "slice_projection", "dotmul_operator", "conv_operator", "mixed_layer",
    # recurrence
    "recurrent_group", "memory", "recurrent_layer", "lstm_step_layer",
    "gru_step_layer", "gru_step_naive_layer", "get_output_layer",
    "beam_search", "eos_layer", "maxid_layer", "sampling_id_layer",
    # remaining layers
    "repeat_layer", "seq_reshape_layer", "seq_concat_layer",
    "seq_slice_layer", "sub_seq_layer", "expand_layer",
    "l2_distance_layer", "power_layer", "interpolation_layer",
    "bilinear_interp_layer", "sum_to_one_norm_layer", "row_l2_norm_layer",
    "conv_shift_layer", "tensor_layer", "selective_fc_layer",
    "linear_comb_layer", "convex_comb_layer", "dot_prod_layer",
    "out_prod_layer", "print_layer", "printer_layer", "priorbox_layer",
    "cross_channel_norm_layer", "multibox_loss_layer",
    "detection_output_layer", "roi_pool_layer", "spp_layer", "pad_layer",
    "multiplex_layer", "row_conv_layer", "prelu_layer",
    "switch_order_layer", "gated_unit_layer", "crop_layer", "clip_layer",
    "kmax_seq_score_layer", "img_pool3d_layer", "img_conv3d_layer",
    "scale_shift_layer", "resize_layer", "scale_sub_region_layer",
    "factorization_machine", "maxout_layer", "block_expand_layer",
    "huber_classification_cost", "sub_nested_seq_layer",
    "cross_entropy_over_beam",
    # activations (completing the 18)
    "BaseActivation", "SequenceSoftmaxActivation", "SqrtActivation",
    "ReciprocalActivation", "SoftSignActivation",
    # attrs
    "HookAttr", "ParamAttr", "ExtraAttr", "ParameterAttribute",
    "ExtraLayerAttribute",
    # poolings (completing the 9)
    "BasePoolingType", "MaxWithMaskPooling", "CudnnMaxPooling",
    "CudnnAvgPooling", "CudnnAvgInclPadPooling", "SquareRootNPooling",
    # optimizers (completing the 13)
    "Optimizer", "BaseSGDOptimizer", "AdamaxOptimizer",
    "DecayedAdaGradOptimizer", "BaseRegularization", "ModelAverage",
    # evaluators (16)
    "evaluator_base", "classification_error_evaluator", "auc_evaluator",
    "pnpair_evaluator", "precision_recall_evaluator", "ctc_error_evaluator",
    "chunk_evaluator", "sum_evaluator", "column_sum_evaluator",
    "value_printer_evaluator", "gradient_printer_evaluator",
    "maxid_printer_evaluator", "maxframe_printer_evaluator",
    "seqtext_printer_evaluator", "classification_error_printer_evaluator",
    "detection_map_evaluator",
    # networks
    "sequence_conv_pool", "simple_img_conv_pool", "img_conv_bn_pool",
    "img_conv_group", "img_separable_conv", "lstmemory_group",
    "lstmemory_unit", "gru_group", "gru_unit", "simple_gru2",
    "bidirectional_gru", "bidirectional_lstm", "text_conv_pool",
    "simple_attention", "dot_product_attention", "multi_head_attention",
    "vgg_16_network", "small_vgg",
]


# --------------------------------------------------------- support classes
class LayerOutput:
    """In this rebuild layer functions return Program Variables directly;
    LayerOutput is kept as the nominal type for isinstance checks in
    ported configs (reference layers.py LayerOutput)."""

    def __new__(cls, *a, **k):
        raise TypeError(
            "LayerOutput is not constructed directly here — layer "
            "functions return Program Variables")


class LayerType:
    """Name constants (reference layers.py LayerType) — retained for
    config compatibility; the Program records op types instead."""
    DATA = "data"
    FC = "fc"
    CONV = "conv"
    POOL = "pool"
    BATCH_NORM = "batch_norm"
    LSTMEMORY = "lstmemory"
    GRUMEMORY = "grumemory"
    COST = "cost"

    @staticmethod
    def is_layer_type(_t):
        return True


class AggregateLevel:
    TO_NO_SEQUENCE = 0
    TO_SEQUENCE = 1
    EACH_TIMESTEP = 0
    EACH_SEQUENCE = 1


class ExpandLevel:
    FROM_NO_SEQUENCE = 0
    FROM_TIMESTEP = 0
    FROM_SEQUENCE = 1


def layer_support(*attrs):
    """Reference decorator validating ExtraLayerAttribute support — a
    no-op here (attributes map to the ops' behaviour directly)."""
    def deco(fn):
        return fn
    return deco


class StaticInput:
    """Non-scanned input to recurrent_group: visible unsliced inside the
    step (reference StaticInput; carried by scan_block's closure env)."""

    def __init__(self, input, is_seq=False, size=None):
        self.input = input
        self.is_seq = is_seq
        self.size = size


class SubsequenceInput:
    """Nested (2-level LoD) sequence input to recurrent_group: the outer
    group iterates SUB-sequences — each step sees a 1-level padded
    sequence [b, t, d] whose ``@LENGTH`` is that sub-sequence's lengths
    (reference recurrent_group over subSequenceStartPositions,
    ``RecurrentGradientMachine`` nested expansion; nested configs
    ``gserver/tests/sequence_nest_rnn.conf``)."""

    def __init__(self, input):
        if getattr(input, "lod_level", 0) < 2:
            raise ValueError(
                "SubsequenceInput needs a nested (lod_level=2) sequence "
                "variable [b, s, t, ...]; declare it with "
                "layers.data(..., lod_level=2)")
        self.input = input


class BaseGeneratedInput:
    pass


class GeneratedInput(BaseGeneratedInput):
    """Generation-mode input to ``beam_search``: at each decode step the
    step function receives the EMBEDDING of the token each beam selected
    last step (reference ``trainer_config_helpers`` GeneratedInput +
    ``RecurrentGradientMachine.h:307-309`` generateSequence/beamSearch).
    ``embedding_name`` shares the trained token-embedding parameter."""

    def __init__(self, size, embedding_name=None, embedding_size=None,
                 **_):
        if not embedding_size:
            raise ValueError("GeneratedInput needs embedding_size")
        self.size = size
        self.embedding_name = embedding_name
        self.embedding_size = embedding_size


class BeamInput:
    """One beam expansion for cross_entropy_over_beam (reference
    ``trainer_config_helpers/layers.py:6362``): the candidate scores of
    every surviving prefix, the selected top-k candidate ids (-1
    padded; e.g. ``kmax_seq_score_layer`` output), and the gold id."""

    def __init__(self, candidate_scores=None, selected_candidates=None,
                 gold=None, **_):
        if candidate_scores is None or selected_candidates is None \
                or gold is None:
            raise ValueError(
                "BeamInput needs candidate_scores, selected_candidates "
                "and gold")
        self.candidate_scores = candidate_scores
        self.selected_candidates = selected_candidates
        self.gold = gold


# ------------------------------------------------------------- projections
class _Projection:
    def __init__(self, kind, input, **kw):
        self.kind = kind
        self.input = input
        self.kw = kw


def full_matrix_projection(input, size=0, param_attr=None, **_):
    return _Projection("full_matrix", input, size=size,
                       param_attr=param_attr)


def trans_full_matrix_projection(input, size=0, param_attr=None, **_):
    return _Projection("trans_full_matrix", input, size=size,
                       param_attr=param_attr)


def table_projection(input, size=0, param_attr=None, **_):
    return _Projection("table", input, size=size, param_attr=param_attr)


def identity_projection(input, offset=None, size=None, **_):
    return _Projection("identity", input, offset=offset, size=size)


def dotmul_projection(input, param_attr=None, **_):
    return _Projection("dotmul", input, param_attr=param_attr)


def scaling_projection(input, param_attr=None, **_):
    return _Projection("scaling", input, param_attr=param_attr)


def context_projection(input, context_len, context_start=None, **_):
    return _Projection("context", input, context_len=context_len,
                       context_start=context_start)


def conv_projection(input, filter_size, num_filters, num_channels=None,
                    stride=1, padding=0, param_attr=None, **_):
    return _Projection("conv", input, filter_size=filter_size,
                       num_filters=num_filters, stride=stride,
                       padding=padding, param_attr=param_attr)


def slice_projection(input, slices, **_):
    return _Projection("slice", input, slices=slices)


def dotmul_operator(a=None, b=None, scale=1.0, **_):
    return _Projection("dotmul_op", a, b=b, scale=scale)


def conv_operator(img=None, filter=None, filter_size=0, num_filters=0,
                  num_channels=None, stride=1, padding=0, **_):
    return _Projection("conv_op", img, filter=filter,
                       filter_size=filter_size, num_filters=num_filters,
                       stride=stride, padding=padding)


def _eval_projection(proj, size):
    """Lower one projection/operator to a Variable (mixed_layer's body)."""
    x = proj.input
    kw = proj.kw
    if proj.kind in ("full_matrix", "trans_full_matrix"):
        out_size = kw["size"] or size
        helper = LayerHelper("proj", name=None)
        in_dim = int(np.prod(x.shape[1:]))
        shape = ([out_size, in_dim] if proj.kind == "trans_full_matrix"
                 else [in_dim, out_size])
        w = helper.create_parameter(kw.get("param_attr"), shape=shape,
                                    dtype=x.dtype)
        return layers.matmul(x, w,
                             transpose_y=proj.kind == "trans_full_matrix")
    if proj.kind == "table":
        return layers.embedding(
            x, size=[_v1._vocab_of(x), kw["size"] or size],
            param_attr=kw.get("param_attr"))
    if proj.kind == "identity":
        if kw.get("offset") is None:
            return x
        off = kw["offset"]
        sz = kw.get("size") or size
        return _tensor.crop(x, shape=[-1, sz], offsets=[0, off])
    if proj.kind == "dotmul":
        helper = LayerHelper("dotmul_proj")
        w = helper.create_parameter(kw.get("param_attr"),
                                    shape=[x.shape[-1]], dtype=x.dtype)
        return layers.elementwise_mul(x, w)
    if proj.kind == "scaling":
        helper = LayerHelper("scaling_proj")
        w = helper.create_parameter(kw.get("param_attr"), shape=[1],
                                    dtype=x.dtype)
        return layers.elementwise_mul(x, w)
    if proj.kind == "context":
        return _context_window(x, kw["context_len"],
                               kw.get("context_start"))
    if proj.kind == "conv":
        return layers.conv2d(
            x, num_filters=kw["num_filters"],
            filter_size=kw["filter_size"], stride=kw["stride"],
            padding=kw["padding"], param_attr=kw.get("param_attr"),
            bias_attr=False)
    if proj.kind == "slice":
        parts = [
            _tensor.crop(x, shape=[-1, e - s], offsets=[0, s])
            for s, e in kw["slices"]
        ]
        return parts[0] if len(parts) == 1 else _tensor.concat(parts, axis=1)
    if proj.kind == "dotmul_op":
        return layers.scale(layers.elementwise_mul(x, kw["b"]),
                            scale=kw["scale"])
    if proj.kind == "conv_op":
        return layers.conv2d(
            x, num_filters=kw["num_filters"],
            filter_size=kw["filter_size"], stride=kw["stride"],
            padding=kw["padding"], bias_attr=False)
    raise ValueError(f"unknown projection {proj.kind}")


def _context_window(x, context_len, context_start=None):
    """Sliding context concat over the time axis (reference
    context_projection): [b, t, d] -> [b, t, context_len*d], zero-padded
    at the borders."""
    start = (-(context_len // 2)) if context_start is None else context_start
    shifted = [_shift_time(x, start + k) for k in range(context_len)]
    return _tensor.concat(shifted, axis=2)


def _shift_time(x, off):
    """x [b, t, ...] shifted by `off` timesteps (positive = look ahead),
    zero-filled."""
    t = x.shape[1]
    rest = list(x.shape[2:])
    if off == 0:
        return x
    if off > 0:
        body = _tensor.crop(x, shape=[-1, t - off] + rest,
                            offsets=[0, off] + [0] * len(rest))
        return _tensor.pad(body,
                           paddings=[0, 0, 0, off] + [0, 0] * len(rest))
    off = -off
    body = _tensor.crop(x, shape=[-1, t - off] + rest,
                        offsets=[0, 0] + [0] * len(rest))
    return _tensor.pad(body, paddings=[0, 0, off, 0] + [0, 0] * len(rest))


def mixed_layer(size=0, input=None, act=None, bias_attr=None, name=None,
                **_):
    """mixed_layer over projections/operators: evaluate each input and
    sum (reference MixedLayerType; += syntax folds to the input list)."""
    ins = input if isinstance(input, (list, tuple)) else [input]
    vals = []
    for p in ins:
        vals.append(_eval_projection(p, size)
                    if isinstance(p, _Projection) else p)
    out = vals[0]
    for v in vals[1:]:
        out = layers.elementwise_add(out, v)
    if bias_attr is not False:
        helper = LayerHelper("mixed", bias_attr=bias_attr)
        out = helper.append_bias_op(out, dim_start=len(out.shape) - 1)
    out = _v1._apply_act(out, _v1._act(act))
    _register_name(out, name)
    return out


# ------------------------------------------------------ recurrent machinery
_RNN_STACK = []


class _V1RnnCtx:
    def __init__(self, rnn, parent_block, sample_outer):
        self.rnn = rnn
        self.parent_block = parent_block
        self.sample_outer = sample_outer  # an outer seq var (batch ref)
        self.mems = []   # (mem_var, name)
        self.named = {}  # layer name -> var (registered inside the step)


def _register_name(var, name):
    if name and _RNN_STACK:
        _RNN_STACK[-1].named[name] = var
    return var


def memory(name=None, size=None, boot_layer=None, is_seq=False, **_):
    """v1 memory(): the loop-carried state, linked by NAME to the step
    layer that produces its next value (reference layers.py memory)."""
    if not _RNN_STACK:
        raise RuntimeError("memory() is only valid inside recurrent_group")
    ctx = _RNN_STACK[-1]
    if boot_layer is not None:
        init = boot_layer
        k = getattr(ctx, "beam_k", None)
        if k:
            # generation mode: the decode loop runs at the flattened
            # [b*k] beam batch, so a boot from encoder state [b, ...]
            # must expand to the beams like StaticInput contexts do
            ex = ctx.parent_block.create_var(
                name=unique_name.generate("beam_boot"),
                dtype=init.dtype,
                shape=[init.shape[0]] + list(init.shape[1:]))
            ctx.parent_block.append_op(
                type="beam_expand", inputs={"X": [init.name]},
                outputs={"Out": [ex.name]}, attrs={"beam_size": k})
            init = ex
    else:
        # zeros [batch, size] built in the PARENT block (the sub-block
        # cannot initialize its own carry)
        init = ctx.parent_block.create_var(
            name=unique_name.generate("rnn_boot"),
            dtype="float32", shape=[ctx.sample_outer.shape[0], size])
        ctx.parent_block.append_op(
            type="fill_constant_batch_size_like",
            inputs={"Input": [ctx.sample_outer.name]},
            outputs={"Out": [init.name]},
            attrs={"shape": (1, size), "dtype": "float32", "value": 0.0,
                   "input_dim_idx": 0, "output_dim_idx": 0},
        )
    mem = ctx.rnn.memory(init)
    ctx.mems.append((mem, name))
    return mem


def recurrent_group(step, input, reverse=False, name=None, **_):
    """Run `step` over each timestep of the sequence inputs (reference
    layers.py recurrent_group -> the scan_block op).  StaticInput wrappers
    pass through unsliced; memories link to same-named step layers.

    ``reverse=True`` (reference ``layers.py:347``): the step visits the
    sequence last-to-first and the outputs come back aligned with the
    INPUT order.  Implemented as length-aware rotation — reverse each
    sequence input (padding stays right-aligned so the group's
    padded-steps-don't-advance-memories masking is untouched), scan
    forward, reverse the outputs back."""
    from ..layers import control_flow as cf

    ins = input if isinstance(input, (list, tuple)) else [input]
    if reverse:
        def _rev(i):
            if isinstance(i, StaticInput):
                return i
            if isinstance(i, SubsequenceInput):
                return SubsequenceInput(layers.sequence_reverse(i.input))
            return layers.sequence_reverse(i)

        ins = [_rev(i) for i in ins]
    seq_ins = [i for i in ins if not isinstance(i, StaticInput)]
    if not seq_ins:
        raise ValueError("recurrent_group needs at least one sequence input")
    rnn = cf.StaticRNN(name=name)
    prog = rnn.helper.main_program
    parent = prog.current_block()
    first = seq_ins[0].input if isinstance(seq_ins[0], SubsequenceInput) \
        else seq_ins[0]
    ctx = _V1RnnCtx(rnn, parent, first)
    _RNN_STACK.append(ctx)
    try:
        with rnn.step():
            step_args = []
            for i in ins:
                if isinstance(i, StaticInput):
                    step_args.append(i.input)  # closure env: unsliced
                elif isinstance(i, SubsequenceInput):
                    # outer iteration over SUB-sequences: the slice
                    # [b, t, d] is itself a 1-level sequence whose
                    # lengths are this step's slice of @SUBLENGTH
                    x = i.input
                    inner = rnn.step_input(x)
                    inner_len = rnn.step_input(x.sub_length_var())
                    inner.lod_level = 1
                    rnn._sub.vars[inner.name + "@LENGTH"] = inner_len
                    step_args.append(inner)
                else:
                    step_args.append(rnn.step_input(i))
            # LoD semantics: padded steps don't advance memories
            if getattr(first, "lod_level", 0) > 0:
                rnn.set_sequence_length(first.length_var())
            outs = step(*step_args)
            outs = outs if isinstance(outs, (list, tuple)) else [outs]
            for mem, mname in ctx.mems:
                target = ctx.named.get(mname)
                if target is None and len(outs) == 1 and len(ctx.mems) == 1:
                    target = outs[0]  # single-memory convention
                if target is None:
                    raise ValueError(
                        f"memory(name={mname!r}) has no same-named step "
                        f"layer; give the producing layer name={mname!r}")
                rnn.update_memory(mem, target)
            for o in outs:
                rnn.step_output(o)
    finally:
        _RNN_STACK.pop()
    result = rnn()
    if getattr(first, "lod_level", 0) > 0:
        # outputs are sequences over the scanned input's lengths (outer
        # lengths for a nested group), so last_seq & friends index the
        # true last step, not the padded one
        out_len = first.length_var()
        for o in (result if isinstance(result, list) else [result]):
            o.lod_level = 1
            o.block.vars[o.name + "@LENGTH"] = out_len
    if reverse:
        # un-rotate so output position t corresponds to input position t
        if isinstance(result, list):
            result = [layers.sequence_reverse(o) for o in result]
        else:
            result = layers.sequence_reverse(result)
    return result


def recurrent_layer(input, act=None, bias_attr=None, param_attr=None,
                    name=None, **_):
    """Elman recurrence out_t = act(in_t + W out_{t-1}) (reference
    RecurrentLayer.cpp)."""
    size = input.shape[-1]

    def step(x_t):
        mem = memory(name="__rec_state", size=size)
        helper = LayerHelper("recurrent")
        w = helper.create_parameter(param_attr, shape=[size, size],
                                    dtype=input.dtype)
        nxt = layers.elementwise_add(x_t, layers.matmul(mem, w))
        nxt = _v1._apply_act(nxt, _v1._act(act, "tanh"))
        _register_name(nxt, "__rec_state")
        return nxt

    out = recurrent_group(step, input, name=name)
    return out


def lstm_step_layer(input, state, size, act=None, gate_act=None,
                    state_act=None, name=None, **_):
    """One LSTM step inside recurrent_group (reference LstmStepLayer):
    ``input`` is already projected to [b, 4*size]; ``state`` is the cell.
    Pure gate math — the recurrent projection lives in the group's
    mixed_layer, exactly the v1 contract.  The new cell is the auxiliary
    'state' output (get_output_layer)."""
    i, f, c_hat, o = _tensor.split(input, 4, dim=1)
    i = layers.sigmoid(i)
    f = layers.sigmoid(f)
    o = layers.sigmoid(o)
    c_hat = layers.tanh(c_hat)
    new_cell = layers.elementwise_add(
        layers.elementwise_mul(f, state),
        layers.elementwise_mul(i, c_hat))
    hidden = layers.elementwise_mul(o, layers.tanh(new_cell))
    hidden._v1_outputs = {"state": new_cell}
    _register_name(hidden, name)
    return hidden


def gru_step_layer(input, output_mem, size=None, act=None, gate_act=None,
                   name=None, **_):
    d = size or output_mem.shape[-1]
    out = layers.gru_unit(input, output_mem, size=3 * d)
    _register_name(out, name)
    return out


gru_step_naive_layer = gru_step_layer


def get_output_layer(input, arg_name, **_):
    """Select a named auxiliary output of a layer (reference
    GetOutputLayer — e.g. lstm 'state').  Layers here stash auxiliaries
    on the Variable (`_v1_outputs`)."""
    outs = getattr(input, "_v1_outputs", None)
    if outs and arg_name in outs:
        return outs[arg_name]
    raise ValueError(
        f"layer has no auxiliary output {arg_name!r}; available: "
        f"{sorted(outs) if outs else '(none)'}")


def beam_search(step, input, bos_id, eos_id, beam_size, max_length=100,
                name=None, **_):
    """The v1 generation entry point: beam search over a recurrent step
    function (reference ``RecurrentGradientMachine.h:307-309``
    generateSequence/beamSearch — per-token dynamic net expansion with
    beam maintenance, exposed via ``api/SequenceGenerator.cpp``).

    Lowering: a fixed-length ``StaticRNN`` decode loop whose
    carried state is (current beam tokens [b, k], accumulated scores
    [b, k], the user step's memories).  Each tick embeds the beams' last
    tokens (the ``GeneratedInput`` contract), runs the user step on the
    flattened [b*k] batch (StaticInput contexts pre-expanded to beams),
    expands/selects with the fixed-width masked ``beam_search`` op, and
    REORDERS every user memory by the selected parents (``beam_gather``)
    — the decoder-state shuffling the reference performs on its
    dynamically expanded nets.  Parent pointers are stacked per step and
    backtracked once at the end (``beam_search_decode``).

    Returns the decoded token variable [b, beam_size, max_length]
    (everything after each hypothesis's first ``eos_id`` is padded with
    ``eos_id``); its ``_v1_outputs['scores']`` carries the final [b, k]
    log-prob scores (``get_output_layer``-accessible)."""
    from ..layers import control_flow as cf

    ins = input if isinstance(input, (list, tuple)) else [input]
    gens = [i for i in ins if isinstance(i, BaseGeneratedInput)]
    if len(gens) != 1:
        raise ValueError("beam_search needs exactly one GeneratedInput")
    g = gens[0]
    statics = [i for i in ins if isinstance(i, StaticInput)]
    if not statics:
        raise ValueError(
            "beam_search needs at least one StaticInput context (the "
            "encoded source) to size the decode batch")
    ref = statics[0].input
    k = int(beam_size)

    helper = LayerHelper("v1_beam_search", name=name)
    block = helper.main_program.current_block()

    emb_attr = (ParamAttr(name=g.embedding_name)
                if g.embedding_name else None)
    emb_w = helper.create_parameter(
        emb_attr, shape=[g.size, g.embedding_size], dtype="float32",
        suffix=None if g.embedding_name else "emb_w")

    # static contexts expand to the beam layout [b*k, ...] — INCLUDING
    # their sequence metadata, so masked sequence ops inside the step
    # (simple_attention etc.) still see lengths for ragged encoders
    expanded = {}
    for s in statics:
        ex = helper.create_tmp_variable(
            s.input.dtype, [s.input.shape[0]] + list(s.input.shape[1:]))
        helper.append_op(
            type="beam_expand", inputs={"X": [s.input.name]},
            outputs={"Out": [ex.name]}, attrs={"beam_size": k})
        if getattr(s.input, "lod_level", 0) > 0:
            exl = helper.create_tmp_variable(
                "int32", [s.input.shape[0]], stop_gradient=True)
            helper.append_op(
                type="beam_expand",
                inputs={"X": [s.input.length_var().name]},
                outputs={"Out": [exl.name]}, attrs={"beam_size": k})
            ex.lod_level = s.input.lod_level
            ex.block.vars[ex.name + "@LENGTH"] = exl
        expanded[id(s)] = ex

    ids0 = helper.create_tmp_variable("int32", [ref.shape[0], k],
                                      stop_gradient=True)
    scores0 = helper.create_tmp_variable("float32", [ref.shape[0], k],
                                         stop_gradient=True)
    helper.append_op(
        type="beam_init", inputs={"Ref": [ref.name]},
        outputs={"Ids": [ids0.name], "Scores": [scores0.name]},
        attrs={"beam_size": k, "bos_id": int(bos_id)})
    # dummy scanned input drives the fixed-length loop
    ticks = helper.create_tmp_variable("float32",
                                       [ref.shape[0], int(max_length)],
                                       stop_gradient=True)
    helper.append_op(
        type="fill_constant_batch_size_like", inputs={"Input": [ref.name]},
        outputs={"Out": [ticks.name]},
        attrs={"shape": (1, int(max_length)), "dtype": "float32",
               "value": 0.0, "input_dim_idx": 0, "output_dim_idx": 0})

    rnn = cf.StaticRNN(name=name)
    ctx = _V1RnnCtx(rnn, block, expanded[id(statics[0])])
    ctx.beam_k = k  # memory(boot_layer=...) must expand boots to beams
    _RNN_STACK.append(ctx)
    try:
        with rnn.step():
            rnn.step_input(ticks)
            cur_ids = rnn.memory(ids0)
            cur_scores = rnn.memory(scores0)
            sub = rnn._sub
            flat_ids = _tensor.reshape(cur_ids, [-1, 1])
            emb = sub.create_var(
                name=unique_name.generate("beam_emb"), dtype="float32",
                shape=[None, g.embedding_size])
            sub.append_op(
                type="lookup_table",
                inputs={"W": [emb_w.name], "Ids": [flat_ids.name]},
                outputs={"Out": [emb.name]}, attrs={"padding_idx": -1})
            emb.shape = (flat_ids.shape[0], g.embedding_size)

            step_args = []
            for i in ins:
                if isinstance(i, BaseGeneratedInput):
                    step_args.append(emb)
                elif isinstance(i, StaticInput):
                    step_args.append(expanded[id(i)])
                else:
                    raise ValueError(
                        "beam_search inputs must be GeneratedInput or "
                        "StaticInput")
            probs = step(*step_args)
            probs = probs if not isinstance(probs, (list, tuple)) \
                else probs[0]
            logp = layers.log(probs)
            logp3 = _tensor.reshape(logp, [-1, k, int(g.size)])
            sel_ids = sub.create_var(
                name=unique_name.generate("beam_ids"), dtype="int32",
                shape=list(cur_ids.shape))
            sel_scores = sub.create_var(
                name=unique_name.generate("beam_scores"), dtype="float32",
                shape=list(cur_scores.shape))
            parent = sub.create_var(
                name=unique_name.generate("beam_parent"), dtype="int32",
                shape=list(cur_ids.shape))
            sub.append_op(
                type="beam_search",
                inputs={"PreIds": [cur_ids.name],
                        "PreScores": [cur_scores.name],
                        "Scores": [logp3.name]},
                outputs={"SelectedIds": [sel_ids.name],
                         "SelectedScores": [sel_scores.name],
                         "ParentIdx": [parent.name]},
                attrs={"beam_size": k, "end_id": int(eos_id)})
            # user memories follow their selected parent beams; unlike
            # recurrent_group there is NO single-memory fallback — the
            # step's return value is the token distribution, never a
            # state, so an unnamed memory is always a config error
            for mem, mname in ctx.mems:
                target = ctx.named.get(mname)
                if target is None:
                    raise ValueError(
                        f"memory(name={mname!r}) inside beam_search has "
                        f"no same-named step layer; name the layer that "
                        f"produces the memory's next value")
                moved = sub.create_var(
                    name=unique_name.generate("beam_mem"),
                    dtype=target.dtype, shape=list(target.shape))
                sub.append_op(
                    type="beam_gather",
                    inputs={"X": [target.name], "Parent": [parent.name]},
                    outputs={"Out": [moved.name]})
                rnn.update_memory(mem, moved)
            rnn.update_memory(cur_ids, sel_ids)
            rnn.update_memory(cur_scores, sel_scores)
            rnn.step_output(sel_ids)
            rnn.step_output(parent)
            rnn.step_output(sel_scores)
    finally:
        _RNN_STACK.pop()
    ids_s, parent_s, scores_s = rnn()   # each [b, T, k]

    def _tbk(x):
        out = helper.create_tmp_variable(x.dtype, [x.shape[1], x.shape[0],
                                                   x.shape[2]])
        helper.append_op(type="transpose", inputs={"X": [x.name]},
                         outputs={"Out": [out.name]},
                         attrs={"axis": (1, 0, 2)})
        return out

    sent = helper.create_tmp_variable(
        "int32", [ref.shape[0], k, int(max_length)], stop_gradient=True)
    sent_scores = helper.create_tmp_variable(
        "float32", [ref.shape[0], k], stop_gradient=True)
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [_tbk(ids_s).name],
                "ParentIdx": [_tbk(parent_s).name],
                "Scores": [_tbk(scores_s).name]},
        outputs={"SentenceIds": [sent.name],
                 "SentenceScores": [sent_scores.name]},
        attrs={"end_id": int(eos_id)})
    sent._v1_outputs = {"scores": sent_scores}
    _register_name(sent, name)
    return sent


def eos_layer(input, eos_id, name=None, **_):
    """1.0 where the id equals eos_id (reference EosIdCheckLayer)."""
    const = _tensor.fill_constant_batch_size_like(
        input, shape=[1] * len(input.shape), dtype=input.dtype,
        value=float(eos_id))
    out = layers.equal(input, const)
    _register_name(out, name)
    return out


def maxid_layer(input, name=None, **_):
    out = _tensor.argmax(input, axis=-1)
    _register_name(out, name)
    return out


def sampling_id_layer(input, name=None, **_):
    helper = LayerHelper("sampling_id", name=name)
    out = helper.create_tmp_variable("int32", list(input.shape[:-1]),
                                     stop_gradient=True)
    helper.append_op(type="sampling_id", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]})
    _register_name(out, name)
    return out


# ---------------------------------------------------------- simple layers
def repeat_layer(input, num_repeats, **_):
    """Tile the feature vector num_repeats times (reference FeatureMapExpand
    / repeat_layer: out size = in size * num_repeats)."""
    return _tensor.expand(input, [1] * (len(input.shape) - 1) + [num_repeats])


def seq_reshape_layer(input, reshape_size, **_):
    return layers.sequence_reshape(input, new_dim=reshape_size)


def seq_concat_layer(a, b, **_):
    """Concatenate two sequences per batch item in time (reference
    SequenceConcatLayer; result lengths add)."""
    from ..layers.nn import _seq_inputs

    helper = LayerHelper("seq_concat")
    t_total = a.shape[1] + b.shape[1]
    out = helper.create_tmp_variable(
        a.dtype, [a.shape[0], t_total] + list(a.shape[2:]), lod_level=1)
    inputs = {"X": [a.name, b.name]}
    lens = []
    for v in (a, b):
        li = {}
        _seq_inputs(li, v)
        lens.extend(li.get("Length", []))
    if len(lens) == 2:
        inputs["Length"] = lens
    helper.append_op(
        type="sequence_concat", inputs=inputs,
        outputs={"Out": [out.name],
                 "OutLength": [out.length_var().name]},
        attrs={"axis": 1})
    return out


def seq_slice_layer(input, starts, ends, **_):
    """v1 contract: [starts, ends) positions -> lengths = ends - starts
    for the sequence_slice op (which takes Offset + SeqLength)."""
    helper = LayerHelper("seq_slice")
    lengths = layers.elementwise_sub(ends, starts)
    out = helper.create_tmp_variable(input.dtype, list(input.shape))
    ln = helper.create_tmp_variable("int32", [input.shape[0]],
                                    stop_gradient=True)
    helper.append_op(
        type="sequence_slice",
        inputs={"X": [input.name], "Offset": [starts.name],
                "SeqLength": [lengths.name]},
        outputs={"Out": [out.name], "OutLength": [ln.name]},
    )
    return out


def sub_seq_layer(input, offsets, sizes, **_):
    return seq_slice_layer(input, offsets, sizes)


def expand_layer(input, expand_as, expand_level=None, **_):
    return layers.sequence_expand(input, expand_as)


def l2_distance_layer(x, y, **_):
    d = layers.elementwise_sub(x, y)
    return layers.sqrt(layers.reduce_sum(layers.square(d), dim=1,
                                         keep_dim=True))


def power_layer(input, other=None, **_):
    """out = other ^ input-per-sample-exponent (reference PowerLayer: the
    FIRST input is the per-sample power [b,1], the second the data)."""
    if isinstance(input, (list, tuple)):
        p, x = input
    else:
        p, x = input, other
    return layers.elementwise_pow(x, p)


def interpolation_layer(input, weight=None, **_):
    """out = w*a + (1-w)*b, per-sample scalar w (reference
    InterpolationLayer; v1 passes [w, a, b] as inputs)."""
    if isinstance(input, (list, tuple)) and len(input) == 3:
        w, a, b = input
    else:
        w, (a, b) = weight, input
    wa = layers.elementwise_mul(a, w)
    one_minus = layers.scale(w, scale=-1.0, bias=1.0)
    wb = layers.elementwise_mul(b, one_minus)
    return layers.elementwise_add(wa, wb)


def bilinear_interp_layer(input, out_size_x, out_size_y, **_):
    helper = LayerHelper("bilinear_interp")
    b, c = input.shape[0], input.shape[1]
    out = helper.create_tmp_variable(
        input.dtype, [b, c, out_size_y, out_size_x])
    helper.append_op(
        type="bilinear_interp", inputs={"X": [input.name]},
        outputs={"Out": [out.name]},
        attrs={"out_h": out_size_y, "out_w": out_size_x},
    )
    return out


def sum_to_one_norm_layer(input, **_):
    s = layers.reduce_sum(input, dim=1, keep_dim=True)
    return layers.elementwise_div(input, s)


def row_l2_norm_layer(input, **_):
    return layers.l2_normalize(input, axis=1)


def conv_shift_layer(a, b, **_):
    helper = LayerHelper("conv_shift")
    out = helper.create_tmp_variable(a.dtype, list(a.shape))
    helper.append_op(type="conv_shift",
                     inputs={"X": [a.name], "Y": [b.name]},
                     outputs={"Out": [out.name]})
    return out


def tensor_layer(a, b, size, act=None, param_attr=None, bias_attr=None,
                 **_):
    out = layers.bilinear_tensor_product(a, b, size, param_attr=param_attr,
                                         bias_attr=bias_attr)
    return _v1._apply_act(out, _v1._act(act))


def selective_fc_layer(input, size, select=None, act=None, param_attr=None,
                       bias_attr=None, **_):
    out = layers.selective_fc(input, size=size, select=select,
                              param_attr=param_attr, bias_attr=bias_attr)
    return _v1._apply_act(out, _v1._act(act, "tanh"))


def linear_comb_layer(weights, vectors, size, **_):
    """out[b, d] = sum_j w[b, j] * v[b, j*d : (j+1)*d] (reference
    LinearCombLayer / convex_comb_layer)."""
    m = weights.shape[-1]
    v3 = _tensor.reshape(vectors, [vectors.shape[0], m, size])
    w3 = _tensor.reshape(weights, [weights.shape[0], m, 1])
    prod = layers.elementwise_mul(v3, w3)
    return layers.reduce_sum(prod, dim=1)


convex_comb_layer = linear_comb_layer


def dot_prod_layer(a, b, **_):
    helper = LayerHelper("dot")
    out = helper.create_tmp_variable(a.dtype, [a.shape[0], 1])
    helper.append_op(type="dot", inputs={"X": [a.name], "Y": [b.name]},
                     outputs={"Out": [out.name]})
    return out


def out_prod_layer(a, b, **_):
    a3 = _tensor.reshape(a, [a.shape[0], a.shape[-1], 1])
    b3 = _tensor.reshape(b, [b.shape[0], 1, b.shape[-1]])
    prod = layers.matmul(a3, b3)
    return _tensor.reshape(prod, [a.shape[0], a.shape[-1] * b.shape[-1]])


def print_layer(input, message="", **_):
    ins = input if isinstance(input, (list, tuple)) else [input]
    helper = LayerHelper("print")
    for v in ins:
        helper.append_op(type="print", inputs={"In": [v.name]},
                         outputs={}, attrs={"message": message})
    return ins[0] if len(ins) == 1 else list(ins)


printer_layer = print_layer


def priorbox_layer(input, image, min_size, max_size=(), aspect_ratio=(),
                   variance=(0.1, 0.1, 0.2, 0.2), **_):
    """Prior boxes flattened to the [2, P, 4] boxes+variances form every
    downstream consumer (multibox_loss_layer / detection_output_layer)
    expects."""
    from ..layers import detection as _det

    boxes, var = _det.prior_box(
        input, image, min_sizes=list(min_size),
        max_sizes=list(max_size or []),
        aspect_ratios=list(aspect_ratio) or [1.0],
        variances=list(variance))
    n = boxes.shape[0] * boxes.shape[1] * boxes.shape[2]
    return _tensor.concat([
        _tensor.reshape(_tensor.reshape(boxes, [n, 4]), [1, n, 4]),
        _tensor.reshape(_tensor.reshape(var, [n, 4]), [1, n, 4]),
    ], axis=0)


def cross_channel_norm_layer(input, **_):
    return layers.l2_normalize(input, axis=1)


def multibox_loss_layer(input_loc, input_conf, priorbox, label_box,
                        label_cls, overlap_threshold=0.5,
                        neg_pos_ratio=3.0, background_id=0, **_):
    from ..layers import detection as _det

    loss = _det.multibox_loss(
        input_loc, input_conf, priorbox, label_box, label_cls,
        overlap_threshold=overlap_threshold, neg_pos_ratio=neg_pos_ratio,
        background_label=background_id)
    return layers.mean(loss)


def detection_output_layer(input_loc, input_conf, priorbox,
                           nms_threshold=0.45, nms_top_k=400,
                           keep_top_k=200, confidence_threshold=0.01,
                           background_id=0, **_):
    from ..layers import detection as _det

    return _det.detection_output(
        input_loc, input_conf, priorbox, background_label=background_id,
        nms_threshold=nms_threshold, nms_top_k=nms_top_k,
        keep_top_k=keep_top_k, score_threshold=confidence_threshold)


def roi_pool_layer(input, rois, pooled_width, pooled_height,
                   spatial_scale=1.0, **_):
    helper = LayerHelper("roi_pool")
    c = input.shape[1]
    out = helper.create_tmp_variable(
        input.dtype, [rois.shape[0], c, pooled_height, pooled_width])
    argmax = helper.create_tmp_variable(
        "int64", [rois.shape[0], c, pooled_height, pooled_width],
        stop_gradient=True)
    helper.append_op(
        type="roi_pool",
        inputs={"X": [input.name], "ROIs": [rois.name]},
        outputs={"Out": [out.name], "Argmax": [argmax.name]},
        attrs={"pooled_height": pooled_height,
               "pooled_width": pooled_width,
               "spatial_scale": spatial_scale},
    )
    return out


def spp_layer(input, pyramid_height, pool_type=None, **_):
    helper = LayerHelper("spp")
    c = input.shape[1]
    n_bins = sum(4 ** i for i in range(pyramid_height))
    out = helper.create_tmp_variable(input.dtype,
                                     [input.shape[0], c * n_bins])
    helper.append_op(
        type="spp", inputs={"X": [input.name]},
        outputs={"Out": [out.name]},
        attrs={"pyramid_height": pyramid_height,
               "pooling_type": _v1._pool_name(pool_type)},
    )
    return out


def pad_layer(input, pad_c=(0, 0), pad_h=(0, 0), pad_w=(0, 0), **_):
    pads = [0, 0, pad_c[0], pad_c[1], pad_h[0], pad_h[1],
            pad_w[0], pad_w[1]]
    return _tensor.pad(input, paddings=pads)


def multiplex_layer(input, **_):
    index, *candidates = input
    return layers.multiplex(candidates, index)


def row_conv_layer(input, context_size, act=None, param_attr=None, **_):
    out = layers.row_conv(input, future_context_size=context_size - 1,
                          param_attr=param_attr)
    return _v1._apply_act(out, _v1._act(act))


def prelu_layer(input, param_attr=None, **_):
    return layers.prelu(input, param_attr=param_attr)


def switch_order_layer(input, reshape_axis=None, **_):
    """NCHW <-> NHWC flip (reference SwitchOrderLayer)."""
    perm = [0, 2, 3, 1] if reshape_axis in (None, 3) else [0, 3, 1, 2]
    return _tensor.transpose(input, perm)


def gated_unit_layer(input, size, act=None, gate_param_attr=None,
                     param_attr=None, **_):
    value = layers.fc(input, size, param_attr=param_attr)
    value = _v1._apply_act(value, _v1._act(act))
    gate = layers.fc(input, size, param_attr=gate_param_attr, act="sigmoid")
    return layers.elementwise_mul(value, gate)


def crop_layer(input, offset, shape=None, axis=2, **_):
    """v1 crop: offset/shape apply FROM `axis` (default 2 = spatial dims);
    leading dims pass through untouched."""
    nd = len(input.shape)
    full_off = [0] * axis + list(offset)
    full_shape = [-1] * axis + list(
        shape if shape is not None
        else [input.shape[axis + i] - o for i, o in enumerate(offset)])
    full_off += [0] * (nd - len(full_off))
    full_shape += [-1] * (nd - len(full_shape))
    return _tensor.crop(input, shape=full_shape, offsets=full_off)


def clip_layer(input, min, max, **_):
    return layers.clip(input, min=min, max=max)


def kmax_seq_score_layer(input, beam_size=1, **_):
    scores = input if len(input.shape) == 2 else \
        _tensor.reshape(input, [input.shape[0], -1])
    _vals, idx = layers.topk(scores, k=beam_size)
    return idx


def img_pool3d_layer(input, pool_size, stride=1, padding=0, pool_type=None,
                     **_):
    return layers.pool3d(input, pool_size=pool_size, pool_stride=stride,
                         pool_padding=padding,
                         pool_type=_v1._pool_name(pool_type))


def img_conv3d_layer(input, filter_size, num_filters, stride=1, padding=0,
                     act=None, param_attr=None, bias_attr=None, **_):
    return layers.conv3d(input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=padding, param_attr=param_attr,
                         bias_attr=bias_attr, act=_v1._act(act, "relu"))


def scale_shift_layer(input, param_attr=None, bias_attr=None, **_):
    helper = LayerHelper("scale_shift")
    w = helper.create_parameter(param_attr, shape=[1], dtype=input.dtype)
    out = layers.elementwise_mul(input, w)
    if bias_attr is not False:
        b = helper.create_parameter(
            _v1_param_attr_or_default(bias_attr), shape=[1],
            dtype=input.dtype, suffix="b")
        out = layers.elementwise_add(out, b)
    return out


def _v1_param_attr_or_default(attr):
    from ..param_attr import ParamAttr as _PA

    return _PA.to_attr(attr) or _PA()


def resize_layer(input, size, **_):
    return _tensor.reshape(input, [input.shape[0], size])


def scale_sub_region_layer(input, indices, value=1.0, **_):
    helper = LayerHelper("scale_sub_region")
    out = helper.create_tmp_variable(input.dtype, list(input.shape))
    helper.append_op(
        type="scale_sub_region",
        inputs={"X": [input.name], "Indices": [indices.name]},
        outputs={"Out": [out.name]}, attrs={"value": float(value)},
    )
    return out


def factorization_machine(input, factor_size, param_attr=None, **_):
    """Second-order FM interactions (reference FactorizationMachineLayer):
    0.5 * sum_f [ (x·V_f)^2 - (x^2)·(V_f^2) ]."""
    helper = LayerHelper("fm")
    d = input.shape[-1]
    v = helper.create_parameter(param_attr, shape=[d, factor_size],
                                dtype=input.dtype)
    xv = layers.matmul(input, v)
    sq_of_sum = layers.square(xv)
    x2 = layers.square(input)
    v2 = layers.square(v)
    sum_of_sq = layers.matmul(x2, v2)
    diff = layers.elementwise_sub(sq_of_sum, sum_of_sq)
    return layers.scale(layers.reduce_sum(diff, dim=1, keep_dim=True),
                        scale=0.5)


def maxout_layer(input, groups, **_):
    helper = LayerHelper("maxout")
    c = input.shape[1]
    out = helper.create_tmp_variable(
        input.dtype, [input.shape[0], c // groups] + list(input.shape[2:]))
    helper.append_op(type="maxout", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"groups": groups})
    return out


def block_expand_layer(input, block_x, block_y, stride_x=1, stride_y=1,
                       padding_x=0, padding_y=0, **_):
    return layers.im2sequence(
        input, filter_size=(block_y, block_x),
        stride=(stride_y, stride_x),
        padding=(padding_y, padding_x, padding_y, padding_x))


def huber_classification_cost(input, label, **_):
    """Two-class huber (reference HuberTwoClassification =
    modified_huber_loss_op semantics)."""
    helper = LayerHelper("mod_huber")
    out = helper.create_tmp_variable(input.dtype, list(input.shape))
    inter = helper.create_tmp_variable(input.dtype, list(input.shape),
                                       stop_gradient=True)
    helper.append_op(
        type="modified_huber_loss",
        inputs={"X": [input.name], "Y": [label.name]},
        outputs={"Out": [out.name], "IntermediateVal": [inter.name]},
    )
    return layers.mean(out)


def sub_nested_seq_layer(input, selected_indices, name=None, **_):
    """Select sub-sequences of a nested input by per-sample indices
    (reference SubNestedSequenceLayer.cpp) — lowers to the native
    sub_nested_seq op."""
    out = layers.sub_nested_seq(input, selected_indices)
    _register_name(out, name)
    return out


def cross_entropy_over_beam(input, name=None, **_):
    """Learning-to-search cost over beam expansions (reference
    ``gserver/layers/CrossEntropyOverBeam.cpp``, DSL
    ``trainer_config_helpers/layers.py:6386``): softmax over the summed
    scores of every complete candidate path through the expansions, NLL
    of the gold path; when the gold falls off the beam at step t the
    cost is over the beam at t with the gold appended as an extra path.
    Lowers to the native ``cross_entropy_over_beam`` op
    (``ops/beam_ce_ops.py``), the static-shape re-design of the
    original's CPU-only per-sequence path loops."""
    if isinstance(input, BeamInput):
        input = [input]
    for ipt in input:
        if not isinstance(ipt, BeamInput):
            raise TypeError(
                "cross_entropy_over_beam input must be BeamInput objects")
    helper = LayerHelper("cross_entropy_over_beam", name=name)
    scores = [b.candidate_scores for b in input]
    ids = [b.selected_candidates for b in input]
    gold = [b.gold for b in input]
    batch = scores[0].shape[0]
    out = helper.create_tmp_variable("float32", [batch, 1])
    helper.append_op(
        type="cross_entropy_over_beam",
        inputs={"Scores": [s.name for s in scores],
                "Ids": [i.name for i in ids],
                "Gold": [g.name for g in gold]},
        outputs={"Out": [out.name]},
    )
    _register_name(out, name)
    return out


# ----------------------------------------------------- activations / attrs
class BaseActivation(_v1._Act):
    pass


SequenceSoftmaxActivation = _v1._act_cls("SequenceSoftmaxActivation",
                                         "sequence_softmax")
SqrtActivation = _v1._act_cls("SqrtActivation", "sqrt")
ReciprocalActivation = _v1._act_cls("ReciprocalActivation", "reciprocal")
SoftSignActivation = _v1._act_cls("SoftSignActivation", "softsign")


class HookAttr:
    """Parameter hooks (pruning etc.) — recorded, not executed; the
    reference applied them trainer-side."""

    def __init__(self, type=None, sparsity_ratio=None):
        self.type = type
        self.sparsity_ratio = sparsity_ratio


from ..param_attr import ParamAttr  # re-export: same role as v1 ParamAttr

ParameterAttribute = ParamAttr


class ExtraLayerAttribute:
    def __init__(self, error_clipping_threshold=None, drop_rate=None,
                 device=None):
        self.error_clipping_threshold = error_clipping_threshold
        self.drop_rate = drop_rate
        self.device = device


ExtraAttr = ExtraLayerAttribute


# ---------------------------------------------------------------- poolings
class BasePoolingType:
    name = None


class MaxWithMaskPooling(BasePoolingType):
    name = "max"


class CudnnMaxPooling(BasePoolingType):
    name = "max"


class CudnnAvgPooling(BasePoolingType):
    name = "avg"


class CudnnAvgInclPadPooling(BasePoolingType):
    name = "avg"


class SquareRootNPooling(BasePoolingType):
    name = "sqrt"


# -------------------------------------------------------------- optimizers
class Optimizer:
    pass


class BaseSGDOptimizer(Optimizer):
    pass


def AdamaxOptimizer(beta1=0.9, beta2=0.999):
    return ("adamax", {"beta1": beta1, "beta2": beta2})


def DecayedAdaGradOptimizer(rho=0.95, epsilon=1e-6):
    return ("decayed_adagrad", {"decay": rho, "epsilon": epsilon})


class BaseRegularization:
    pass


def ModelAverage(average_window, max_average_window=None,
                 average_decay=None, **_):
    """v1 windowed parameter averaging -> the EMA-based ModelAverage.
    A window covering a fraction w of recent steps corresponds roughly to
    decay = 1 - 1/(w * max_window) over max_average_window steps."""
    if average_decay is None:
        horizon = max(2.0, float(average_window)
                      * float(max_average_window or 10000))
        average_decay = 1.0 - 1.0 / horizon
    return _opt.ModelAverage(average_decay=average_decay)


# -------------------------------------------------------------- evaluators
def evaluator_base(input, type, label=None, weight=None, name=None,
                   top_k=None, chunk_scheme=None, num_chunk_types=None,
                   excluded_chunk_types=None, positive_label=None,
                   query_id=None, **_):
    """Generic evaluator dispatcher (reference
    ``trainer_config_helpers/evaluators.py:71``: every ``*_evaluator``
    funnels into evaluator_base with a ``type`` string).  Maps the type
    to the corresponding in-program metric layer; reference evaluators
    attached to the config proto, here they are ordinary fetchable
    metric variables."""
    t = str(type)
    if t in ("classification_error", "classification_error_printer"):
        return layers.accuracy(input=input, label=label,
                               k=top_k or 1)
    if t == "auc":
        return layers.auc(input=input, label=label)
    if t in ("chunk", "chunk_evaluator"):
        return layers.chunk_eval(
            input=input, label=label, chunk_scheme=chunk_scheme or "IOB",
            num_chunk_types=num_chunk_types or 1,
            excluded_chunk_types=excluded_chunk_types)
    if t in ("precision_recall", "precision_recall_evaluator"):
        return precision_recall_evaluator(input, label,
                                          positive_label=positive_label)
    if t in ("pnpair", "pnpair_evaluator"):
        if query_id is None:
            raise ValueError("pnpair evaluator needs query_id")
        return pnpair_evaluator(input, label, query_id, weight=weight)
    if t in ("sum", "sum_evaluator"):
        return sum_evaluator(input)
    if t in ("column_sum", "column_sum_evaluator", "last-column-sum"):
        return column_sum_evaluator(input)
    if t in ("ctc_edit_distance", "ctc_error", "ctc_error_evaluator"):
        return ctc_error_evaluator(input, label)
    if t in ("last-column-auc",):
        return layers.auc(input=input, label=label)
    if t in ("max_id_printer", "maxid_printer"):
        return maxid_printer_evaluator(input)
    if t in ("max_frame_printer", "maxframe_printer"):
        return maxframe_printer_evaluator(input)
    # printer family: evaluation-time inspection — fetch the value
    # itself.  Only types whose reference semantics ARE "print the
    # input" may fall through; gradient_printer attaches to gradients
    # (reference evaluators.py:630), which a fetch-the-input shim would
    # silently misrepresent — reject it instead.
    if t == "gradient_printer":
        raise ValueError(
            "gradient_printer attaches to parameter gradients; fetch "
            "<param>@GRAD explicitly instead of using the evaluator shim")
    if t in ("value_printer", "seq_text_printer"):
        return input
    raise ValueError(f"unknown evaluator type {type!r}")


def classification_error_evaluator(input, label, **_):
    return layers.accuracy(input=input, label=label)


def auc_evaluator(input, label, **_):
    return layers.auc(input=input, label=label)


def pnpair_evaluator(input, label, query_id, **_):
    helper = LayerHelper("pnpair")
    outs = {
        n: helper.create_tmp_variable("float32", [1], stop_gradient=True)
        for n in ("PositivePair", "NegativePair", "NeutralPair")
    }
    helper.append_op(
        type="positive_negative_pair",
        inputs={"Score": [input.name], "Label": [label.name],
                "QueryID": [query_id.name]},
        outputs={k: [v.name] for k, v in outs.items()},
    )
    return (outs["PositivePair"], outs["NegativePair"],
            outs["NeutralPair"])


def precision_recall_evaluator(input, label, positive_label=None, **_):
    helper = LayerHelper("precision_recall")
    idx = _tensor.argmax(input, axis=-1)
    batch = helper.create_tmp_variable("float32", [6], stop_gradient=True)
    accum = helper.create_tmp_variable("float32", [6], stop_gradient=True)
    states = helper.create_tmp_variable(
        "float32", [input.shape[-1], 4], stop_gradient=True)
    helper.append_op(
        type="precision_recall",
        inputs={"Indices": [idx.name], "Labels": [label.name]},
        outputs={"BatchMetrics": [batch.name],
                 "AccumMetrics": [accum.name],
                 "AccumStatesInfo": [states.name]},
        attrs={"class_number": input.shape[-1]},
    )
    return batch


def ctc_error_evaluator(input, label, **_):
    decoded = layers.ctc_greedy_decoder(input,
                                        blank=input.shape[-1] - 1)
    dist, _ = layers.edit_distance(decoded, label, normalized=True)
    return dist


def chunk_evaluator(input, label, chunk_scheme="IOB", num_chunk_types=1,
                    excluded_chunk_types=None, **_):
    return layers.chunk_eval(
        input, label, chunk_scheme=chunk_scheme,
        num_chunk_types=num_chunk_types,
        excluded_chunk_types=excluded_chunk_types)


def sum_evaluator(input, **_):
    return layers.reduce_sum(input)


def column_sum_evaluator(input, **_):
    return layers.reduce_sum(input, dim=0)


def value_printer_evaluator(input, **_):
    return print_layer(input, message="[value]")


def gradient_printer_evaluator(input, **_):
    # gradients are autograd internals here; print the forward value with
    # a marker (the v1 original printed param grads trainer-side)
    return print_layer(input, message="[grad-of]")


def maxid_printer_evaluator(input, **_):
    return print_layer(maxid_layer(input), message="[maxid]")


def maxframe_printer_evaluator(input, **_):
    return print_layer(maxid_layer(input), message="[maxframe]")


def seqtext_printer_evaluator(input, result_file=None, **_):
    return print_layer(input, message="[seqtext]")


def classification_error_printer_evaluator(input, label, **_):
    acc = layers.accuracy(input=input, label=label)
    return print_layer(acc, message="[classification_error]")


def detection_map_evaluator(input, label, overlap_threshold=0.5,
                            ap_type="integral", evaluate_difficult=False,
                            **_):
    """Host-side DetectionMAP (fetch detections, update per batch)."""
    return _eval.DetectionMAP(overlap_threshold=overlap_threshold,
                              ap_version=ap_type,
                              evaluate_difficult=evaluate_difficult)


# ---------------------------------------------------------------- networks
def sequence_conv_pool(input, context_len, hidden_size, **_):
    return _nets.sequence_conv_pool(input, num_filters=hidden_size,
                                    filter_size=context_len)


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         pool_stride=1, act=None, **_):
    return _nets.simple_img_conv_pool(
        input, num_filters=num_filters, filter_size=filter_size,
        pool_size=pool_size, pool_stride=pool_stride,
        act=_v1._act(act, "relu"))


def img_conv_bn_pool(input, filter_size, num_filters, pool_size,
                     pool_stride=1, act=None, **_):
    return _nets.img_conv_bn_pool(
        input, num_filters=num_filters, filter_size=filter_size,
        pool_size=pool_size, pool_stride=pool_stride,
        act=_v1._act(act, "relu"))


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, pool_stride=2,
                   conv_with_batchnorm=False, **_):
    return _nets.img_conv_group(
        input, conv_num_filter=conv_num_filter, pool_size=pool_size,
        conv_padding=conv_padding, conv_filter_size=conv_filter_size,
        conv_act=_v1._act(conv_act, "relu"), pool_stride=pool_stride,
        conv_with_batchnorm=conv_with_batchnorm)


def img_separable_conv(input, num_channels, num_out_channels, filter_size,
                       stride=1, padding=0, act=None, **_):
    return _nets.img_separable_conv(
        input, num_channels=num_channels,
        num_out_channels=num_out_channels, filter_size=filter_size,
        stride=stride, padding=padding, act=_v1._act(act, "relu"))


def lstmemory_unit(input, size, name=None, act=None, gate_act=None,
                   state_act=None, **_):
    """One LSTM step — call INSIDE recurrent_group with the step input
    (reference networks.py lstmemory_unit): projects [x_t, out_mem] to
    4*size gates, applies lstm_step_layer, links the cell memory."""
    name = name or unique_name.generate("lstm_unit")
    out_mem = memory(name=name, size=size)
    cell_mem = memory(name=name + "_cell", size=size)
    proj = mixed_layer(
        size=4 * size,
        input=[full_matrix_projection(input, 4 * size),
               full_matrix_projection(out_mem, 4 * size)])
    hidden = lstm_step_layer(proj, cell_mem, size=size, name=name)
    _register_name(get_output_layer(hidden, "state"), name + "_cell")
    return hidden


def lstmemory_group(input, size, reverse=False, **_):
    proj = layers.fc(input, size * 4, num_flatten_dims=2)
    layers.link_sequence(proj, input)
    hidden, _cell = layers.dynamic_lstm(proj, size=size * 4,
                                        is_reverse=reverse)
    return hidden


def gru_unit(input=None, size=None, name=None, **_):
    """One GRU step — call INSIDE recurrent_group with the step input
    (reference networks.py gru_unit): projects x_t to 3*size and applies
    gru_step_layer against the output memory."""
    name = name or unique_name.generate("gru_unit")
    mem = memory(name=name, size=size)
    proj = mixed_layer(
        size=3 * size,
        input=[full_matrix_projection(input, 3 * size)],
        bias_attr=False)
    out = gru_step_layer(proj, mem, size=size, name=name)
    return out


def gru_group(input, size, reverse=False, **_):
    proj = layers.fc(input, size * 3, num_flatten_dims=2)
    layers.link_sequence(proj, input)
    return layers.dynamic_gru(proj, size=size, is_reverse=reverse)


def simple_gru2(input, size, reverse=False, **_):
    return _v1.simple_gru(input, size, reverse=reverse)


def bidirectional_gru(input, size, return_concat=True, **_):
    return _nets.bidirectional_gru(input, size,
                                   return_concat=return_concat)


def bidirectional_lstm(input, size, return_concat=True, **_):
    return _nets.bidirectional_lstm(input, size,
                                    return_concat=return_concat)


def text_conv_pool(input, context_len, hidden_size, **_):
    return _nets.sequence_conv_pool(input, num_filters=hidden_size,
                                    filter_size=context_len)


def simple_attention(encoded_sequence, encoded_proj, decoder_state, **_):
    return _nets.simple_attention(encoded_sequence, encoded_proj,
                                  decoder_state,
                                  decoder_size=decoder_state.shape[-1])


def dot_product_attention(attended_sequence, attending_sequence=None,
                          transform_param_attr=None, **kw):
    q = kw.get("queries", attending_sequence)
    k = kw.get("keys", attended_sequence)
    v = kw.get("values", attended_sequence)
    return _nets.dot_product_attention(q, k, v)


def multi_head_attention(query, key, value, head_num, **_):
    return layers.multi_head_attention(query, key, value,
                                       d_model=query.shape[-1],
                                       n_head=head_num)


def vgg_16_network(input_image, num_channels, num_classes=1000, **_):
    """VGG-16 (reference networks.py vgg_16_network)."""
    tmp = _nets.img_conv_group(
        input_image, conv_num_filter=[64, 64], pool_size=2,
        conv_filter_size=3, conv_act="relu", pool_stride=2,
        conv_with_batchnorm=True)
    tmp = _nets.img_conv_group(
        tmp, conv_num_filter=[128, 128], pool_size=2, conv_filter_size=3,
        conv_act="relu", pool_stride=2, conv_with_batchnorm=True)
    tmp = _nets.img_conv_group(
        tmp, conv_num_filter=[256, 256, 256], pool_size=2,
        conv_filter_size=3, conv_act="relu", pool_stride=2,
        conv_with_batchnorm=True)
    tmp = _nets.img_conv_group(
        tmp, conv_num_filter=[512, 512, 512], pool_size=2,
        conv_filter_size=3, conv_act="relu", pool_stride=2,
        conv_with_batchnorm=True)
    tmp = _nets.img_conv_group(
        tmp, conv_num_filter=[512, 512, 512], pool_size=2,
        conv_filter_size=3, conv_act="relu", pool_stride=2,
        conv_with_batchnorm=True)
    tmp = layers.fc(tmp, 4096, act="relu")
    tmp = layers.dropout(tmp, dropout_prob=0.5)
    tmp = layers.fc(tmp, 4096, act="relu")
    tmp = layers.dropout(tmp, dropout_prob=0.5)
    return layers.fc(tmp, num_classes, act="softmax")


def small_vgg(input_image, num_channels, num_classes=10, **_):
    tmp = _nets.img_conv_group(
        input_image, conv_num_filter=[64, 64], pool_size=2,
        conv_filter_size=3, conv_act="relu", pool_stride=2,
        conv_with_batchnorm=True)
    tmp = _nets.img_conv_group(
        tmp, conv_num_filter=[128, 128], pool_size=2, conv_filter_size=3,
        conv_act="relu", pool_stride=2, conv_with_batchnorm=True)
    tmp = layers.dropout(tmp, dropout_prob=0.5)
    tmp = layers.fc(tmp, 512, act="relu")
    return layers.fc(tmp, num_classes, act="softmax")
