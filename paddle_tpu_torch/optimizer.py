"""Optimizers: build the backward pass then append one update op per param.

The port's copy of ``paddle_tpu/optimizer.py`` (reference:
python/paddle/fluid/optimizer.py — Optimizer:34, minimize:224, SGD:250,
Momentum:268, Adam:361): ``minimize`` appends the gradient ops
(core/backward.py), the clip and regularization ops (none unless set),
and an update op per parameter, with the same var names, ops and attrs
as the JAX package. Adagrad, Adamax, DecayedAdagrad, Adadelta, RMSProp,
Ftrl and LarsMomentum wait for later slices.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .clip import append_gradient_clip_ops
from .core.backward import append_backward
from .core.scope import global_scope
from .framework import Program, Variable, default_startup_program, \
    unique_name
from .regularizer import append_regularization_ops


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._lr = learning_rate
        self._lr_var: Optional[Variable] = None
        self.regularization = regularization
        self._name = name
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self.type = getattr(self, "type", "optimizer")

    # -- learning rate ------------------------------------------------------
    def _create_lr_var(self, program: Program) -> Variable:
        if self._lr_var is not None:
            return self._lr_var
        name = unique_name("learning_rate")
        block = program.global_block()
        lr = block.create_var(name=name, shape=[1], dtype="float32",
                              persistable=True, stop_gradient=True)
        startup = default_startup_program().global_block()
        sv = startup.create_var(name=name, shape=[1], dtype="float32",
                                persistable=True)
        init_val = self._lr if isinstance(self._lr, (int, float)) \
            else self._lr(0)
        startup.append_op("fill_constant", outputs={"Out": sv},
                          attrs={"shape": [1], "dtype": "float32",
                                 "value": float(init_val)})
        self._lr_var = lr
        return lr

    @property
    def learning_rate_var(self):
        return self._lr_var

    def set_lr_in_scope(self, step: int, scope=None):
        """Host-side schedule hook: refresh the LR value for `step`, on
        the device the scope's LR tensor lies on."""
        if not callable(self._lr) or self._lr_var is None:
            return
        scope = global_scope() if scope is None else scope
        cur = scope.get(self._lr_var.name)
        scope.set(self._lr_var.name,
                  torch.full((1,), float(self._lr(step)),
                             dtype=torch.float32, device=cur.device))

    # -- accumulators -------------------------------------------------------
    def _add_accumulator(self, name: str, param: Variable, fill_value=0.0,
                         shape=None, dtype=None) -> Variable:
        table = self._accumulators.setdefault(name, {})
        if param.name in table:
            return table[param.name]
        var_name = unique_name(f"{param.name}_{name}")
        shape = shape if shape is not None else list(param.shape)
        dtype = dtype or param.dtype
        block = param.block.program.global_block()
        acc = block.create_var(name=var_name, shape=shape, dtype=dtype,
                               persistable=True, stop_gradient=True)
        startup = default_startup_program().global_block()
        sv = startup.create_var(name=var_name, shape=shape, dtype=dtype,
                                persistable=True)
        startup.append_op("fill_constant", outputs={"Out": sv},
                          attrs={"shape": shape, "dtype": dtype,
                                 "value": float(fill_value)})
        table[param.name] = acc
        return acc

    def _get_accumulator(self, name: str, param: Variable) -> Variable:
        return self._accumulators[name][param.name]

    # -- hooks for subclasses ----------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- the pass -----------------------------------------------------------
    def _create_optimization_pass(self, params_grads, loss):
        program = loss.block.program
        block = program.global_block()
        self._create_lr_var(program)
        self._create_accumulators(block, [p for p, _ in params_grads])
        return [self._append_optimize_op(block, pg) for pg in params_grads]

    def minimize(self, loss: Variable, startup_program=None,
                 parameter_list=None, no_grad_set=None):
        pg_names = append_backward(loss, parameter_list=parameter_list,
                                   no_grad_set=no_grad_set)
        block = loss.block.program.global_block()
        params_grads: List[Tuple[Variable, Variable]] = [
            (block.var(pname), block.var(gname))
            for pname, gname in pg_names]
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        opt_ops = self._create_optimization_pass(params_grads, loss)
        return opt_ops, params_grads


class SGDOptimizer(Optimizer):
    type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd", inputs={"Param": p, "Grad": g,
                           "LearningRate": self._lr_var},
            outputs={"ParamOut": p})


class MomentumOptimizer(Optimizer):
    type = "momentum"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            inputs={"Param": p, "Grad": g, "Velocity": v,
                    "LearningRate": self._lr_var},
            outputs={"ParamOut": p, "VelocityOut": v},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, fill_value=self._beta1,
                                  shape=[1])
            self._add_accumulator("beta2_pow", p, fill_value=self._beta2,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow", p)
        b2p = self._get_accumulator("beta2_pow", p)
        return block.append_op(
            "adam",
            inputs={"Param": p, "Grad": g, "Moment1": m1, "Moment2": m2,
                    "LearningRate": self._lr_var, "Beta1Pow": b1p,
                    "Beta2Pow": b2p},
            outputs={"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
                     "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


# Aliases matching the reference's public names.
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
