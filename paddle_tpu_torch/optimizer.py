"""Optimizers: build the backward pass then append one update op per param.

The port's copy of ``paddle_tpu/optimizer.py`` (reference:
python/paddle/fluid/optimizer.py — Optimizer:34, minimize:224, SGD:250,
Momentum:268, Adagrad:320, Adam:361, Adamax:466, DecayedAdagrad:550,
Adadelta:594, RMSProp:676, ModelAverage:811, plus Ftrl and
LarsMomentum): ``minimize`` appends the gradient ops (core/backward.py),
the clip and regularization ops (none unless set), and an update op per
parameter, with the same var names, ops and attrs as the JAX package. A
learning rate may be a schedule (layers/learning_rate_scheduler.py),
which ``set_lr_in_scope`` reads.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch

from . import framework
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

    def _finish_update(self, block):
        pass

    # -- the pass -----------------------------------------------------------
    def _create_optimization_pass(self, params_grads, loss):
        program = loss.block.program
        block = program.global_block()
        self._create_lr_var(program)
        self._create_accumulators(block, [p for p, _ in params_grads])
        ops = [self._append_optimize_op(block, pg) for pg in params_grads]
        self._finish_update(block)
        return ops

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


class AdagradOptimizer(Optimizer):
    type = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            inputs={"Param": p, "Grad": g, "Moment": m,
                    "LearningRate": self._lr_var},
            outputs={"ParamOut": p, "MomentOut": m},
            attrs={"epsilon": self._epsilon})


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


class AdamaxOptimizer(Optimizer):
    type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "adamax",
            inputs={"Param": p, "Grad": g,
                    "Moment": self._get_accumulator("moment", p),
                    "InfNorm": self._get_accumulator("inf_norm", p),
                    "LearningRate": self._lr_var,
                    "Beta1Pow": self._get_accumulator("beta1_pow", p)},
            outputs={"ParamOut": p,
                     "MomentOut": self._get_accumulator("moment", p),
                     "InfNormOut": self._get_accumulator("inf_norm", p)},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block):
        """beta1_pow *= beta1 after every parameter's update (a scale op
        each, as the reference appends them)."""
        for b1p in self._accumulators.get("beta1_pow", {}).values():
            block.append_op("scale", inputs={"X": b1p},
                            outputs={"Out": b1p},
                            attrs={"scale": self._beta1})


class DecayedAdagradOptimizer(Optimizer):
    type = "decayed_adagrad"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": p, "Grad": g, "Moment": m,
                    "LearningRate": self._lr_var},
            outputs={"ParamOut": p, "MomentOut": m},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    type = "adadelta"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sg = self._get_accumulator("avg_squared_grad", p)
        su = self._get_accumulator("avg_squared_update", p)
        return block.append_op(
            "adadelta",
            inputs={"Param": p, "Grad": g, "AvgSquaredGrad": sg,
                    "AvgSquaredUpdate": su},
            outputs={"ParamOut": p, "AvgSquaredGradOut": sg,
                     "AvgSquaredUpdateOut": su},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    type = "rmsprop"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon, self._momentum = rho, epsilon, momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        mom = self._get_accumulator("momentum", p)
        ms = self._get_accumulator("mean_square", p)
        return block.append_op(
            "rmsprop",
            inputs={"Param": p, "Grad": g, "Moment": mom,
                    "MeanSquare": ms, "LearningRate": self._lr_var},
            outputs={"ParamOut": p, "MomentOut": mom,
                     "MeanSquareOut": ms},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum})


class FtrlOptimizer(Optimizer):
    type = "ftrl"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            "ftrl",
            inputs={"Param": p, "Grad": g, "SquaredAccumulator": sq,
                    "LinearAccumulator": lin,
                    "LearningRate": self._lr_var},
            outputs={"ParamOut": p, "SquaredAccumOut": sq,
                     "LinearAccumOut": lin},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class LarsMomentumOptimizer(Optimizer):
    type = "lars_momentum"

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            inputs={"Param": p, "Grad": g, "Velocity": v,
                    "LearningRate": self._lr_var},
            outputs={"ParamOut": p, "VelocityOut": v},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay})


class ModelAverage(Optimizer):
    """Sliding-window parameter averaging (reference: optimizer.py:811).

    Appends an ``average_accumulates`` op per parameter to the main
    program; ``apply()`` swaps the averaged values into the parameters
    (backing the current values up in the grad vars) and ``restore()``
    swaps them back: two small programs run on demand, as the reference
    builds them."""

    def __init__(self, params_grads, average_window_rate,
                 min_average_window=10000, max_average_window=10000, **kw):
        super().__init__(0.0, **kw)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params_grads = [(p, g) for p, g in params_grads
                             if g is not None]
        for param, _ in self.params_grads:
            self._append_average_accumulate_op(param)
        self.apply_program = Program()
        with framework.program_guard(self.apply_program,
                                     default_startup_program()):
            for param, grad in self.params_grads:
                self._add_average_apply_op(param, grad)
        self.restore_program = Program()
        with framework.program_guard(self.restore_program,
                                     default_startup_program()):
            for param, grad in self.params_grads:
                self._add_average_restore_op(param, grad)

    def _clone_into(self, block, var):
        return block.create_var(name=var.name, shape=list(var.shape),
                                dtype=var.dtype, persistable=True)

    def _add_average_apply_op(self, param, grad):
        block = self.apply_program.global_block()
        p = self._clone_into(block, param)
        g = self._clone_into(block, grad)
        s1, s2, s3, num_acc, old_num = (
            self._clone_into(block, self._get_accumulator(n, param))
            for n in ("sum_1", "sum_2", "sum_3", "num_accumulates",
                      "old_num_accumulates"))
        # the current value backed up in the grad var
        block.append_op("assign", inputs={"X": p}, outputs={"Out": g})
        # param = (sum_1 + sum_2 + sum_3) / (num_accumulates + old_num)
        total = block.create_var(shape=list(param.shape), dtype=param.dtype)
        block.append_op("sum", inputs={"X": [s1, s2, s3]},
                        outputs={"Out": total})
        n = block.create_var(shape=[1], dtype="int32")
        block.append_op("sum", inputs={"X": [num_acc, old_num]},
                        outputs={"Out": n})
        nf = block.create_var(shape=[1], dtype="float32")
        block.append_op("cast", inputs={"X": n}, outputs={"Out": nf},
                        attrs={"in_dtype": "int32",
                               "out_dtype": "float32"})
        block.append_op("elementwise_div", inputs={"X": total, "Y": nf},
                        outputs={"Out": p}, attrs={"axis": -1})

    def _add_average_restore_op(self, param, grad):
        block = self.restore_program.global_block()
        p = self._clone_into(block, param)
        g = self._clone_into(block, grad)
        block.append_op("assign", inputs={"X": g}, outputs={"Out": p})

    def _append_average_accumulate_op(self, param):
        block = param.block.program.global_block()
        s1 = self._add_accumulator("sum_1", param)
        s2 = self._add_accumulator("sum_2", param)
        s3 = self._add_accumulator("sum_3", param)
        num_acc = self._add_accumulator("num_accumulates", param,
                                        dtype="int32", shape=[1])
        old_num = self._add_accumulator("old_num_accumulates", param,
                                        dtype="int32", shape=[1])
        num_upd = self._add_accumulator("num_updates", param,
                                        dtype="int32", shape=[1])
        block.append_op(
            "average_accumulates",
            inputs={"param": param, "in_sum_1": s1, "in_sum_2": s2,
                    "in_sum_3": s3, "in_num_accumulates": num_acc,
                    "in_old_num_accumulates": old_num,
                    "in_num_updates": num_upd},
            outputs={"out_sum_1": s1, "out_sum_2": s2, "out_sum_3": s3,
                     "out_num_accumulates": num_acc,
                     "out_old_num_accumulates": old_num,
                     "out_num_updates": num_upd},
            attrs={"average_window": float(self.average_window),
                   "min_average_window": int(self.min_average_window),
                   "max_average_window": int(self.max_average_window)})

    @contextmanager
    def apply(self, executor, need_restore=True):
        """The averaged values in the parameters for the body of the
        `with` block (restored after it unless need_restore is False)."""
        executor.run(self.apply_program)
        try:
            yield
        finally:
            if need_restore:
                self.restore(executor)

    def restore(self, executor):
        executor.run(self.restore_program)


# Aliases matching the reference's public names.
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer
