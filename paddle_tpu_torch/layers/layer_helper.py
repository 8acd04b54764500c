"""LayerHelper — shared plumbing for layer functions (the port's copy of
``paddle_tpu/layers/layer_helper.py``): create parameters in the startup
program (with initializer ops) and main program, create temporaries,
append bias/activation ops."""

import numpy as np

from ..core.program import default_main_program, default_startup_program, Variable
from ..core import unique_name
from ..param_attr import ParamAttr
from .. import initializer as init_mod


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name or unique_name.generate(layer_type)
        self.main_program = kwargs.get("main_program") or default_main_program()
        self.startup_program = (
            kwargs.get("startup_program") or default_startup_program()
        )

    @property
    def main_block(self):
        return self.main_program.current_block()

    def append_op(self, **kwargs):
        return self.main_block.append_op(**kwargs)

    def create_tmp_variable(self, dtype, shape=None, lod_level=0, stop_gradient=False):
        return self.main_block.create_var(
            name=unique_name.generate(f"{self.name}.tmp"),
            dtype=dtype,
            shape=shape or (),
            lod_level=lod_level,
            stop_gradient=stop_gradient,
        )

    def create_parameter(
        self, attr, shape, dtype, suffix="w", default_initializer=None
    ):
        attr = ParamAttr.to_attr(attr)
        if attr is None:
            return None
        name = attr.name or f"{self.name}.{suffix}"
        # Explicitly-named parameters are shared across layers (the reference
        # reuses the variable when two layers name the same ParamAttr, e.g.
        # word2vec's shared embedding table).
        gb = self.main_program.global_block()
        if attr.name is not None and attr.name in gb.vars:
            from ..core.program import Parameter
            from ..core.dtypes import convert_dtype

            existing = gb.vars[attr.name]
            if not isinstance(existing, Parameter):
                raise ValueError(
                    f"param_attr name {attr.name!r} collides with a "
                    f"non-parameter variable"
                )
            if tuple(existing.shape) != tuple(shape):
                raise ValueError(
                    f"shared parameter {attr.name!r} reused with shape "
                    f"{tuple(shape)} != existing {tuple(existing.shape)}"
                )
            if existing.dtype != convert_dtype(dtype):
                raise ValueError(
                    f"shared parameter {attr.name!r} reused with dtype "
                    f"{dtype} != existing {existing.dtype.name}"
                )
            return existing
        init = attr.initializer or default_initializer
        if init is None:
            if suffix == "b":
                init = init_mod.Constant(0.0)
            else:
                init = init_mod.Xavier()
        # main-program parameter (referenced by compute ops)
        param = self.main_program.global_block().create_parameter(
            name=name,
            shape=shape,
            dtype=dtype,
            trainable=attr.trainable,
            regularizer=attr.regularizer,
            gradient_clip_attr=attr.gradient_clip,
            optimize_attr={"learning_rate": attr.learning_rate},
            initializer=init,
        )
        # startup-program twin + its init op
        sb = self.startup_program.global_block()
        if name not in sb.vars:
            svar = sb.create_var(
                name=name, shape=shape, dtype=dtype, persistable=True
            )
            init(svar, sb)
        return param

    def create_global_variable(
        self, shape, dtype, name=None, persistable=True, initializer=None,
        stop_gradient=True,
    ):
        """Non-trainable persistable state (BN stats, metric accumulators,
        LR counters)."""
        name = name or unique_name.generate(f"{self.name}.global")
        var = self.main_program.global_block().create_var(
            name=name, shape=shape, dtype=dtype, persistable=persistable,
            stop_gradient=stop_gradient,
        )
        if initializer is not None:
            sb = self.startup_program.global_block()
            if name not in sb.vars:
                svar = sb.create_var(
                    name=name, shape=shape, dtype=dtype, persistable=True
                )
                initializer(svar, sb)
        return var

    # -- composite helpers -------------------------------------------------
    def input_dtype(self, x):
        return x.dtype

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.kwargs.get("bias_attr")
        if bias_attr is False:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        b = self.create_parameter(
            ParamAttr.to_attr(bias_attr), shape=size, dtype=input_var.dtype,
            suffix="b", default_initializer=init_mod.Constant(0.0),
        )
        if b is None:
            return input_var
        out = self.create_tmp_variable(input_var.dtype, input_var.shape)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var.name], "Y": [b.name]},
            outputs={"Out": [out.name]},
            attrs={"axis": dim_start},
        )
        return out

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        out = self.create_tmp_variable(input_var.dtype, input_var.shape)
        self.append_op(
            type=act_type,
            inputs={"X": [input_var.name]},
            outputs={"Out": [out.name]},
            attrs=act,
        )
        return out


def seq_length(x):
    """The Length input for sequence-aware ops: the shadow ``@LENGTH`` var
    if x is a sequence (lod_level > 0), else None."""
    if getattr(x, "lod_level", 0) and x.lod_level > 0:
        return x.length_var()
    return None
