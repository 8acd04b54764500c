"""The v1 layer DSL (``paddle_tpu_torch.compat.v1``) against the JAX
package's (``paddle_tpu.compat.v1``) on the CPU.

Each case is a config of the JAX package's v1 tests
(``tests/test_compat_v1.py``, ``test_compat_v1_ext.py``,
``test_nested_sequences.py``, ``test_beam_ce.py``,
``test_v1_generation.py``) written once against a package argument and
built in both packages: the two Programs (main and startup) are the same
op for op and variable for variable.  The reference's startup state goes
into the port through ``load_numpy_state``; dropout is 0 on both sides.
Both run the same feeds (from a numpy seed); every fetch has the
reference's shape, ints and bools are equal, floats within ORACLE_TOL
f32's forward bound (2e-4 of the largest).  A config that trains runs a
few steps and holds each step's fetches the same way, so the optimizer's
updates are held too.  ``sampling_id`` and ``nce`` draw inside the op
(threefry against the port's generator), so their outputs are held by
shape here and by distribution in ``test_torch_sampling.py``.
"""

import inspect

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.kernels.xla_ref import ORACLE_TOL
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

FWD_TOL = ORACLE_TOL[("flash_attention", "float32")]["fwd"]     # 2e-4
BOS, EOS = 0, 1


def _program(pkg, build):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        fetches = build(pkg, pkg.compat.v1)
    for blk in main.blocks:
        for op in blk.ops:
            if "dropout_prob" in op.attrs:
                op.attrs["dropout_prob"] = 0.0
    fetches = fetches if isinstance(fetches, (list, tuple)) else [fetches]
    return main, startup, [f.name for f in fetches]


def _describe(program):
    ops = [(blk.idx, op.type, op.inputs, op.outputs, op.attrs, op.role)
           for blk in program.blocks for op in blk.ops]
    variables = [(v.name, tuple(v.shape), v.dtype.name, v.persistable,
                  v.stop_gradient, v.lod_level)
                 for v in program.list_vars()]
    return ops, variables


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def run_both(build, feed, steps=1, shape_only=()):
    """Build ``build(pkg, v1)`` in both packages, run ``steps`` times from
    the reference's startup state, and hold every fetch.  Returns the
    port's last fetches."""
    jmain, jstart, names = _program(pt, build)
    tmain, tstart, tnames = _program(tpt, build)
    assert tnames == names
    assert _describe(tmain) == _describe(jmain)
    assert _describe(tstart) == _describe(jstart)
    jscope, jexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    jexe.run(jstart, scope=jscope)
    init = {v.name: np.asarray(jscope.get(v.name))
            for v in jmain.persistable_vars()
            if jscope.find_var(v.name) is not None}
    tscope = tpt.load_numpy_state(tpt.Scope(), init, device="cpu")
    texe = tpt.Executor(tpt.CPUPlace())
    for step in range(steps):
        want = jexe.run(jmain, feed=feed, fetch_list=names, scope=jscope)
        got = texe.run(tmain, feed=feed, fetch_list=names, scope=tscope)
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape, (step, names[i], g.shape, w.shape)
            if i in shape_only:
                continue
            if w.dtype.kind in "biu":
                np.testing.assert_array_equal(g, w, err_msg=names[i])
            else:
                assert _rel(g, w) <= FWD_TOL, (step, names[i], _rel(g, w))
    return got


# ---------------------------------------------------------------- configs
def smallnet(pkg, v1):
    """benchmark/paddle/image/smallnet_mnist_cifar.py with v1 names,
    Momentum and L2 weight decay."""
    net = v1.data_layer("data", size=3 * 32 * 32, height=32, width=32)
    label = v1.data_layer("label", size=1, is_label=True)
    net = v1.img_conv_layer(input=net, filter_size=5, num_filters=32,
                            stride=1, padding=2, act=v1.ReluActivation())
    net = v1.img_pool_layer(input=net, pool_size=3, stride=2, padding=1)
    net = v1.img_conv_layer(input=net, filter_size=5, num_filters=32,
                            stride=1, padding=2, act=v1.ReluActivation())
    net = v1.img_pool_layer(input=net, pool_size=3, stride=2, padding=1,
                            pool_type=v1.AvgPooling())
    net = v1.fc_layer(input=net, size=64, act=v1.ReluActivation())
    out = v1.fc_layer(input=net, size=10, act=v1.SoftmaxActivation())
    cost = v1.classification_cost(input=out, label=label)
    v1.settings(batch_size=4, learning_rate=0.002,
                learning_method=v1.MomentumOptimizer(0.9),
                regularization=v1.L2Regularization(1e-4)).minimize(cost)
    return cost, out


def lstm_text(pkg, v1):
    """benchmark/paddle/rnn/rnn.py's shape: embedding -> simple_lstm ->
    max pooling -> fc, under Adam."""
    words = v1.data_layer("words", size=50, dtype="int64", seq_len=12)
    label = v1.data_layer("label", size=1, is_label=True)
    emb = v1.embedding_layer(input=words, size=16)
    lstm = v1.simple_lstm(input=emb, size=16)
    pooled = v1.pooling_layer(input=lstm, pooling_type=v1.MaxPooling())
    out = v1.fc_layer(input=pooled, size=2, act=v1.SoftmaxActivation())
    cost = v1.classification_cost(input=out, label=label)
    v1.settings(learning_rate=0.05,
                learning_method=v1.AdamOptimizer()).minimize(cost)
    return cost, out


def misc(pkg, v1):
    a = v1.data_layer("a", size=8)
    b = v1.data_layer("b", size=8)
    return (v1.addto_layer([a, b], act=v1.TanhActivation()),
            v1.concat_layer([a, b]), v1.cos_sim(a, b),
            v1.slope_intercept_layer(a, slope=2.0, intercept=1.0),
            v1.trans_layer(a), v1.max_id(a), v1.sum_cost(a),
            v1.regression_cost(a, b), v1.scaling_layer(a, b))


def projections(pkg, v1):
    d = v1.data_layer("x", size=6)
    return (
        v1.mixed_layer(size=6, input=[v1.identity_projection(d)]),
        v1.mixed_layer(size=5, input=[v1.full_matrix_projection(d, size=5),
                                      v1.full_matrix_projection(d, size=5)],
                       bias_attr=False),
        v1.mixed_layer(size=4, input=[v1.trans_full_matrix_projection(
            d, size=4)], bias_attr=False),
        v1.mixed_layer(size=6, input=[v1.dotmul_projection(d)],
                       bias_attr=False),
        v1.mixed_layer(size=4, input=[v1.slice_projection(
            d, [(0, 2), (4, 6)])], bias_attr=False),
        v1.mixed_layer(size=6, input=[v1.scaling_projection(d)],
                       bias_attr=False),
        v1.mixed_layer(size=6, input=[v1.dotmul_operator(d, d, scale=2.0)],
                       bias_attr=False),
        v1.mixed_layer(size=3, input=[v1.identity_projection(
            d, offset=2, size=3)], bias_attr=False),
        v1.fc_layer(input=[d, d], size=3))


def context(pkg, v1):
    d = pkg.layers.data("x", shape=[4, 3], dtype="float32")
    return (v1.mixed_layer(size=9, input=[v1.context_projection(d, 3)],
                           bias_attr=False),
            v1.mixed_layer(size=6, input=[v1.context_projection(
                d, 2, context_start=0)], bias_attr=False))


def recurrence(pkg, v1):
    d = pkg.layers.data("x", shape=[5, 3], dtype="float32")
    c = pkg.layers.data("c", shape=[3], dtype="float32")

    def cumsum(x_t):
        return v1.addto_layer([x_t, v1.memory(name="acc", size=3)],
                              name="acc")

    def with_ctx(x_t, ctx_in):
        mem = v1.memory(name="s", size=3)
        return v1.addto_layer([x_t, mem, ctx_in], name="s")

    return (v1.recurrent_group(cumsum, d), v1.recurrent_layer(d),
            v1.recurrent_group(with_ctx, [d, v1.StaticInput(c)]))


def step_layers(pkg, v1):
    d = pkg.layers.data("x8", shape=[3, 8], dtype="float32")
    from_ext = pkg.compat.v1_ext

    def lstm_step(x_t):
        cell = v1.memory(name="c", size=2)
        h = v1.lstm_step_layer(x_t, cell, size=2, name="h")
        from_ext._register_name(v1.get_output_layer(h, "state"), "c")
        return h

    def gru_step(x_t):
        mem = v1.memory(name="g", size=4)
        return v1.gru_step_layer(
            v1.fc_layer(x_t, 12, act=v1.IdentityActivation(),
                        bias_attr=False), mem, size=4, name="g")

    return (v1.recurrent_group(lstm_step, d),
            v1.recurrent_group(gru_step, d),
            v1.recurrent_group(lambda x_t: v1.lstmemory_unit(x_t, size=4),
                               d),
            v1.recurrent_group(lambda x_t: v1.gru_unit(x_t, size=4), d))


def elementwise(pkg, v1):
    L = pkg.layers
    a, b = L.data("a", shape=[4]), L.data("b", shape=[4])
    w, p = L.data("w", shape=[1]), L.data("p", shape=[1])
    wv, vv = L.data("wv", shape=[3]), L.data("vv", shape=[12])
    return (v1.power_layer([p, a]), v1.interpolation_layer([w, a, b]),
            v1.sum_to_one_norm_layer(a), v1.row_l2_norm_layer(a),
            v1.l2_distance_layer(a, b), v1.dot_prod_layer(a, b),
            v1.out_prod_layer(a, b), v1.repeat_layer(a, 3),
            v1.linear_comb_layer(wv, vv, size=4),
            v1.factorization_machine(vv, factor_size=3),
            v1.conv_shift_layer(vv, wv),
            v1.tensor_layer(a, b, size=3, act=v1.TanhActivation()),
            v1.selective_fc_layer(a, size=5))


def image(pkg, v1):
    L = pkg.layers
    d = L.data("img", shape=[3, 8, 8], dtype="float32")
    vol = L.data("vol", shape=[2, 4, 6, 6], dtype="float32")
    return (v1.bilinear_interp_layer(d, out_size_x=16, out_size_y=12),
            v1.maxout_layer(L.conv2d(d, 4, 3, padding=1), groups=2),
            v1.switch_order_layer(d),
            v1.pad_layer(d, pad_c=(1, 1), pad_h=(0, 2), pad_w=(1, 0)),
            v1.block_expand_layer(d, block_x=4, block_y=4, stride_x=4,
                                  stride_y=4),
            v1.spp_layer(d, pyramid_height=2),
            v1.spp_layer(d, pyramid_height=3, pool_type=v1.AvgPooling()),
            v1.resize_layer(d, size=3 * 64), v1.cross_channel_norm_layer(d),
            v1.img_cmrnorm_layer(d, size=3),
            v1.img_conv3d_layer(vol, filter_size=3, num_filters=3,
                                padding=1),
            v1.img_pool3d_layer(vol, pool_size=2, stride=2),
            v1.img_pool3d_layer(vol, pool_size=3, stride=2, padding=1,
                                pool_type=v1.AvgPooling()),
            v1.crop_layer(d, offset=[1, 2], shape=[5, 4]))


def shift_gate(pkg, v1):
    L = pkg.layers
    d = L.data("img2", shape=[2, 3, 3], dtype="float32")
    di = L.data("ind", shape=[6], dtype="int64")
    flat = v1.resize_layer(d, size=18)
    return (v1.scale_sub_region_layer(d, di, value=4.0),
            v1.scale_shift_layer(flat), v1.gated_unit_layer(flat, size=5),
            v1.clip_layer(flat, min=-0.5, max=0.5), v1.prelu_layer(flat),
            v1.batch_norm_layer(d, act=v1.ReluActivation()),
            v1.dropout_layer(flat, dropout_rate=0.5))


def sequence_ids(pkg, v1):
    L = pkg.layers
    d = L.data("xs", shape=[4, 6], dtype="float32")
    dp = L.data("p", shape=[3], dtype="float32")
    di = L.data("i", shape=[1], dtype="int64")
    return (v1.seq_reshape_layer(d, reshape_size=3), v1.maxid_layer(dp),
            v1.eos_layer(di, eos_id=1), v1.kmax_seq_score_layer(
                dp, beam_size=2), v1.sampling_id_layer(dp))


def costs(pkg, v1):
    L = pkg.layers
    d = L.data("x3", shape=[3], dtype="float32")
    lbl = L.data("y", shape=[1], dtype="int64")
    fy = L.data("fy", shape=[1], dtype="float32")
    prob = v1.fc_layer(d, 2, act=v1.SoftmaxActivation())
    logit = v1.fc_layer(d, 1, act=v1.IdentityActivation())
    feat = v1.fc_layer(d, 8, act=v1.TanhActivation())
    return (v1.classification_error_evaluator(prob, lbl),
            v1.huber_classification_cost(logit, lbl),
            v1.multi_binary_label_cross_entropy(logit, fy),
            v1.smooth_l1_cost(logit, fy), v1.huber_regression_cost(logit, fy),
            v1.hsigmoid(feat, lbl, num_classes=6), v1.mse_cost(logit, fy),
            v1.cross_entropy(prob, lbl),
            v1.rank_cost(logit, v1.fc_layer(d, 1, act=None), lbl),
            v1.nce_layer(feat, lbl, num_classes=7, num_neg_samples=3),
            v1.auc_evaluator(prob, lbl))


def evaluators(pkg, v1):
    L = pkg.layers
    inf = L.data("inf", shape=[10], dtype="int64", lod_level=1)
    lab = L.data("lab", shape=[10], dtype="int64", lod_level=1)
    score = L.data("score", shape=[1], dtype="float32")
    plab = L.data("plab", shape=[1], dtype="int64")
    qid = L.data("qid", shape=[1], dtype="int64")
    probs = L.data("probs", shape=[4], dtype="float32")
    acts = L.data("acts", shape=[6, 5], dtype="float32", lod_level=1)
    tgt = L.data("tgt", shape=[4], dtype="int64", lod_level=1)
    return (list(v1.chunk_evaluator(inf, lab, chunk_scheme="IOBES",
                                    num_chunk_types=2))
            + list(v1.evaluator_base(inf, "chunk", label=lab,
                                     chunk_scheme="IOB", num_chunk_types=4,
                                     excluded_chunk_types=[1]))
            + list(v1.pnpair_evaluator(score, plab, qid))
            + [v1.precision_recall_evaluator(probs, plab),
               v1.sum_evaluator(probs), v1.column_sum_evaluator(probs),
               v1.ctc_error_evaluator(acts, tgt),
               v1.classification_error_evaluator(probs, plab),
               v1.evaluator_base(probs, "classification_error", label=plab,
                                 top_k=2)])


def small_vgg(pkg, v1):
    d = pkg.layers.data("img", shape=[3, 32, 32], dtype="float32")
    return v1.small_vgg(d, num_channels=3, num_classes=10)


def _proj(L, seq, size):
    out = L.fc(seq, size, num_flatten_dims=2)
    L.link_sequence(out, seq)
    return out


def attention_misc(pkg, v1):
    L = pkg.layers
    sa = L.data("a", shape=[3, 4], dtype="float32", lod_level=1)
    sb = L.data("b", shape=[2, 4], dtype="float32", lod_level=1)
    dec = L.data("dec", shape=[4], dtype="float32")
    return (v1.seq_concat_layer(sa, sb), v1.simple_attention(sa, sa, dec),
            v1.multi_head_attention(sa, sa, sa, head_num=2),
            v1.last_seq(sa), v1.first_seq(sa),
            v1.pooling_layer(sa, pooling_type=v1.SumPooling()),
            v1.expand_layer(dec, sa), v1.grumemory(_proj(L, sa, 12), size=4),
            v1.lstmemory(_proj(L, sa, 16), size=4),
            v1.gru_group(sa, size=3, reverse=True),
            v1.lstmemory_group(sa, size=3),
            v1.row_conv_layer(sa, context_size=2))


def ssd(pkg, v1):
    L = pkg.layers
    T = pkg.layers.tensor
    img = L.data("img16", shape=[3, 16, 16], dtype="float32")
    gb = L.data("gb", shape=[2, 4], dtype="float32")
    gl = L.data("gl", shape=[2], dtype="int64")
    feat = L.conv2d(img, 8, 3, padding=1, act="relu")
    feat = L.pool2d(feat, pool_size=4, pool_stride=4)
    pb = v1.priorbox_layer(feat, img, min_size=[4.0], max_size=[8.0])
    p = pb.shape[1]
    loc = T.reshape(T.transpose(L.conv2d(feat, 8, 3, padding=1),
                                [0, 2, 3, 1]), [2, p, 4])
    conf = T.reshape(T.transpose(L.conv2d(feat, 6, 3, padding=1),
                                 [0, 2, 3, 1]), [2, p, 3])
    return (v1.multibox_loss_layer(loc, conf, pb, gb, gl),
            v1.detection_output_layer(loc, conf, pb))


def reverse(pkg, v1):
    x = pkg.layers.data("xr", shape=[6, 2], dtype="float32", lod_level=1)
    para = pkg.layers.data("para", shape=[3, 4, 3], dtype="float32",
                           lod_level=2)

    def step(x_t):
        mem = v1.memory(name="acc", size=2)
        nxt = pkg.layers.elementwise_add(mem, x_t)
        pkg.compat.v1_ext._register_name(nxt, "acc")
        return nxt

    def outer_step(sent):
        omem = v1.memory(name="oacc", size=3)
        nxt = pkg.layers.elementwise_add(
            omem, pkg.layers.sequence_pool(sent, "sum"))
        pkg.compat.v1_ext._register_name(nxt, "oacc")
        return nxt

    out = v1.recurrent_group(step=step, input=x, reverse=True)
    return (out, v1.last_seq(input=out),
            v1.recurrent_group(outer_step, v1.SubsequenceInput(para),
                               reverse=True))


def nested_group(pkg, v1):
    """sequence_nest_rnn.conf: an outer group over sub-sequences whose
    inner group boots from the outer memory."""
    d = 5
    para = pkg.layers.data("para5", shape=[3, 4, d], dtype="float32",
                           lod_level=2)

    def outer_step(sent):
        omem = v1.memory(name="outer", size=d)

        def inner_step(x_t):
            imem = v1.memory(name="inner", size=d, boot_layer=omem)
            return v1.mixed_layer(
                size=d,
                input=[v1.full_matrix_projection(
                    x_t, size=d, param_attr=pkg.ParamAttr(name="w_in")),
                    v1.full_matrix_projection(
                        imem, size=d,
                        param_attr=pkg.ParamAttr(name="w_rec"))],
                act=v1.TanhActivation(), bias_attr=False, name="inner")

        lastv = v1.last_seq(v1.recurrent_group(inner_step, sent))
        v1.mixed_layer(size=d, input=[v1.identity_projection(lastv)],
                       bias_attr=False, name="outer")
        return lastv

    out = v1.recurrent_group(outer_step, v1.SubsequenceInput(para))
    return v1.last_seq(out), out


def nested_layers(pkg, v1):
    """The nested layers and ``sub_nested_seq_layer``; the paragraph
    classifier (fc to gates -> ``nested_rnn`` -> last outer state) trains
    under SGD."""
    L = pkg.layers
    h = 6
    para = L.data("para4", shape=[3, 5, 4], dtype="float32", lod_level=2)
    idx = L.data("idx", shape=[2], dtype="int64")
    label = L.data("label", shape=[1], dtype="int64")
    sel = v1.sub_nested_seq_layer(para, idx)
    gates = L.fc(para, 3 * h, num_flatten_dims=3, bias_attr=False)
    L.link_sequence(gates, para)
    gates.lod_level = 2
    gates.block.vars[gates.name + "@SUBLENGTH"] = para.sub_length_var()
    hidden, outer = L.nested_rnn(gates, h)
    logits = L.fc(L.sequence_pool(outer, "last"), 2)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return (loss, hidden, L.nested_sequence_pool(sel, "sum"),
            L.nested_sequence_pool(para, "max"),
            L.nested_sequence_expand(L.nested_sequence_pool(para, "last"),
                                     para))


def beam_ce(pkg, v1):
    ins = []
    for e, rows in enumerate((1, 2)):
        sc = pkg.layers.data(f"sc{e}", shape=[rows, 5], dtype="float32")
        idv = pkg.layers.data(f"id{e}", shape=[rows, 2], dtype="int64")
        gv = pkg.layers.data(f"g{e}", shape=[1], dtype="int64")
        ins.append(v1.BeamInput(candidate_scores=sc,
                                selected_candidates=idv, gold=gv))
    return v1.cross_entropy_over_beam(input=ins)


def beam_search(pkg, v1):
    """The seq2seq generation pattern: the decoder memory boots from the
    encoder's state, beam 3, 5 steps."""
    h, e, vocab = 4, 3, 6
    ctx = pkg.layers.data("ctx", shape=[4], dtype="float32")
    boot = v1.mixed_layer(size=h, input=[v1.full_matrix_projection(
        ctx, size=h)], act=v1.TanhActivation(), bias_attr=False)

    def step(emb, enc):
        mem = v1.memory(name="dec", size=h, boot_layer=boot)
        hid = v1.mixed_layer(
            size=h, input=[v1.full_matrix_projection(emb, size=h),
                           v1.full_matrix_projection(mem, size=h),
                           v1.full_matrix_projection(enc, size=h)],
            act=v1.TanhActivation(), bias_attr=False, name="dec")
        return v1.mixed_layer(size=vocab, input=[v1.full_matrix_projection(
            hid, size=vocab)], act=v1.SoftmaxActivation(), bias_attr=False)

    sent = v1.beam_search(step, input=[
        v1.GeneratedInput(size=vocab, embedding_size=e),
        v1.StaticInput(ctx)], bos_id=BOS, eos_id=EOS, beam_size=3,
        max_length=5)
    return sent, v1.get_output_layer(sent, "scores")


def _chunks(rng, b, t, labels):
    lens = rng.integers(1, t + 1, b).astype(np.int32)
    return rng.integers(0, labels, (b, t)).astype(np.int64), lens


def _feed(name, rng):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    if name == "smallnet":
        return {"data": f(4, 3, 32, 32),
                "label": rng.integers(0, 10, (4, 1))}
    if name == "lstm_text":
        return {"words": rng.integers(0, 50, (4, 12)),
                "words@LENGTH": np.array([12, 7, 3, 12], np.int32),
                "label": rng.integers(0, 2, (4, 1))}
    if name == "misc":
        return {"a": f(2, 8), "b": f(2, 8)}
    if name == "projections":
        return {"x": f(3, 6)}
    if name == "context":
        return {"x": f(2, 4, 3)}
    if name == "recurrence":
        return {"x": f(2, 5, 3), "c": f(2, 3)}
    if name == "step_layers":
        return {"x8": f(2, 3, 8)}
    if name == "elementwise":
        return {"a": rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32),
                "b": rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32),
                "w": rng.uniform(0.1, 0.9, (3, 1)).astype(np.float32),
                "p": np.full((3, 1), 2.0, np.float32),
                "wv": f(3, 3), "vv": f(3, 12)}
    if name == "image":
        return {"img": f(2, 3, 8, 8), "vol": f(2, 2, 4, 6, 6)}
    if name == "shift_gate":
        return {"img2": f(1, 2, 3, 3),
                "ind": np.array([[1, 1, 1, 2, 1, 3]], np.int64)}
    if name == "sequence_ids":
        return {"xs": f(2, 4, 6),
                "p": np.array([[0.05, 0.9, 0.05], [0.8, 0.1, 0.1]],
                              np.float32),
                "i": np.array([[1], [0]], np.int64)}
    if name == "costs":
        return {"x3": f(6, 3), "y": rng.integers(0, 2, (6, 1)),
                "fy": f(6, 1)}
    if name == "evaluators":
        inf, il = _chunks(rng, 4, 10, 9)
        lab = inf.copy()
        lab[rng.random(lab.shape) < 0.3] = 2
        acts = f(3, 6, 5)
        return {"inf": inf, "inf@LENGTH": il, "lab": lab, "lab@LENGTH": il,
                "score": np.round(f(12, 1), 1),
                "plab": rng.integers(0, 4, (12, 1)),
                "qid": rng.integers(0, 3, (12, 1)),
                "probs": np.abs(f(12, 4)),
                "acts": acts, "acts@LENGTH": np.array([6, 4, 5], np.int32),
                "tgt": rng.integers(0, 4, (3, 4)),
                "tgt@LENGTH": np.array([3, 4, 2], np.int32)}
    if name == "small_vgg":
        return {"img": f(2, 3, 32, 32)}
    if name == "attention_misc":
        return {"a": f(2, 3, 4), "a@LENGTH": np.array([3, 2], np.int32),
                "b": f(2, 2, 4), "b@LENGTH": np.array([2, 1], np.int32),
                "dec": f(2, 4)}
    if name == "ssd":
        gb = np.zeros((2, 2, 4), np.float32)
        gb[:, 0] = (0.2, 0.2, 0.5, 0.5)
        return {"img16": rng.random((2, 3, 16, 16)).astype(np.float32),
                "gb": gb, "gl": np.array([[1, -1], [1, -1]], np.int64)}
    if name == "reverse":
        return {"xr": f(3, 6, 2), "xr@LENGTH": np.array([4, 6, 2], np.int32),
                "para": f(2, 3, 4, 3),
                "para@LENGTH": np.array([3, 2], np.int32),
                "para@SUBLENGTH": np.array([[4, 2, 3], [3, 4, 0]], np.int32)}
    if name == "nested_group":
        return {"para5": f(2, 3, 4, 5) * 0.5,
                "para5@LENGTH": np.array([3, 2], np.int32),
                "para5@SUBLENGTH": np.array([[4, 2, 3], [3, 4, 0]],
                                            np.int32)}
    if name == "nested_layers":
        sub = rng.integers(1, 6, (4, 3)).astype(np.int32)
        ln = np.array([3, 2, 1, 3], np.int32)
        sub *= (np.arange(3)[None] < ln[:, None])
        return {"para4": f(4, 3, 5, 4), "para4@LENGTH": ln,
                "para4@SUBLENGTH": sub,
                "idx": np.array([[1, 0], [0, -1], [2, 0], [2, 1]]),
                "label": rng.integers(0, 2, (4, 1))}
    if name == "beam_ce":
        return {"sc0": f(3, 1, 5), "id0": np.array([[[1, 3]]] * 3),
                "g0": np.array([[3], [1], [4]]), "sc1": f(3, 2, 5),
                "id1": np.array([[[0, 2], [4, -1]]] * 3),
                "g1": np.array([[2], [0], [1]])}
    if name == "beam_search":
        return {"ctx": f(2, 4)}
    raise KeyError(name)


CONFIGS = {f.__name__: f for f in (
    smallnet, lstm_text, misc, projections, context, recurrence,
    step_layers, elementwise, image, shift_gate, sequence_ids, costs,
    evaluators, small_vgg, attention_misc, ssd, reverse, nested_group,
    nested_layers, beam_ce, beam_search)}
# trained configs run 3 steps; outputs drawn inside an op are held by shape
STEPS = {"smallnet": 3, "lstm_text": 3, "nested_layers": 3}
SHAPE_ONLY = {"sequence_ids": (4,), "costs": (9,)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_v1_config_matches_the_reference(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    run_both(CONFIGS[name], _feed(name, rng), steps=STEPS.get(name, 1),
             shape_only=SHAPE_ONLY.get(name, ()))


def test_surface_is_the_references():
    """The same ``__all__`` as the JAX package's v1 (its
    ``test_surface_count_vs_reference`` counts >= 190 names), every name
    defined, none raising ``NotImplementedError``."""
    jv1, tv1 = pt.compat.v1, tpt.compat.v1
    assert tv1.__all__ == jv1.__all__
    assert len(tv1.__all__) >= 190
    assert all(hasattr(tv1, n) for n in tv1.__all__)
    assert tpt.compat.__all__ == pt.compat.__all__ == ["v1"]
    offenders = []
    for n in tv1.__all__:
        try:
            src = inspect.getsource(getattr(tv1, n))
        except (TypeError, OSError):
            continue
        if "raise NotImplementedError" in src:
            offenders.append(n)
    assert not offenders, offenders


def test_triaged_names_raise_with_native_pointer():
    """Bad arguments raise the reference's argument errors."""
    v1 = tpt.compat.v1
    with pytest.raises(ValueError, match="GeneratedInput"):
        v1.beam_search(None, [v1.StaticInput(None)], 0, 1, 4)
    with pytest.raises(ValueError, match="embedding_size"):
        v1.GeneratedInput(size=10)
    with pytest.raises(ValueError, match="lod_level=2"):
        v1.SubsequenceInput(None)
    with pytest.raises(TypeError, match="BeamInput"):
        v1.cross_entropy_over_beam([object()])
    with pytest.raises(ValueError, match="candidate_scores"):
        v1.BeamInput()
    with pytest.raises(TypeError, match="not constructed directly"):
        v1.LayerOutput()
    with pytest.raises(RuntimeError, match="recurrent_group"):
        v1.memory(name="m", size=2)
    tpt.core.unique_name.reset()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        p = tpt.layers.data("p", shape=[4])
        lbl = tpt.layers.data("l", shape=[1], dtype="int64")
        with pytest.raises(ValueError, match="unknown evaluator"):
            v1.evaluator_base(input=p, type="nope", label=lbl)
        with pytest.raises(ValueError, match="gradient_printer"):
            v1.evaluator_base(input=p, type="gradient_printer")
        with pytest.raises(ValueError, match="vocabulary"):
            v1.embedding_layer(p, size=4)


def test_settings_and_model_average_build_the_ports_classes():
    """``settings()`` maps the v1 optimizers onto the port's (the same
    class names and arguments as the reference's), and ``ModelAverage``
    on the port's."""
    v1, jv1 = tpt.compat.v1, pt.compat.v1
    for method in ("MomentumOptimizer", "AdamOptimizer", "AdaGradOptimizer",
                   "RMSPropOptimizer", "AdaDeltaOptimizer"):
        t = v1.settings(learning_rate=0.1,
                        learning_method=getattr(v1, method)())
        j = jv1.settings(learning_rate=0.1,
                         learning_method=getattr(jv1, method)())
        assert type(t).__name__ == type(j).__name__
        assert type(t).__module__ == "paddle_tpu_torch.optimizer"
    tpt.core.unique_name.reset()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", shape=[3])
        y = tpt.layers.data("y", shape=[1])
        cost = tpt.layers.mean(tpt.layers.square_error_cost(
            tpt.layers.fc(x, 1), y))
        tpt.optimizer.SGD(0.1).minimize(cost)
        ma = v1.ModelAverage(0.5)
    assert isinstance(ma, tpt.optimizer.ModelAverage)
    assert v1.inputs(x) == [x] and v1.outputs(cost) == [cost]
