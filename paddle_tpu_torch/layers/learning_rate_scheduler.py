"""Learning-rate schedules: the port's copy of
``paddle_tpu/layers/learning_rate_scheduler.py`` (reference:
python/paddle/fluid/layers/learning_rate_scheduler.py).

Each is a host-side function of the global step, not a graph: an
Optimizer given one as its learning rate fills its LR variable with
lr(0) at startup (``Optimizer._create_lr_var``) and writes lr(step) into
the scope on ``Optimizer.set_lr_in_scope(step)``, on the device the LR
tensor lies on."""
from __future__ import annotations

import math

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay",
           "cosine_decay"]


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    def sched(step):
        exp = step / decay_steps
        if staircase:
            exp = math.floor(exp)
        return learning_rate * (decay_rate ** exp)
    return sched


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    def sched(step):
        exp = step / decay_steps
        if staircase:
            exp = math.floor(exp)
        return learning_rate * math.exp(-decay_rate * exp)
    return sched


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    def sched(step):
        frac = step / decay_steps
        if staircase:
            frac = math.floor(frac)
        return learning_rate / (1 + decay_rate * frac)
    return sched


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    def sched(step):
        if cycle:
            div = max(1.0, math.ceil(step / decay_steps))
            steps = decay_steps * div
        else:
            steps = decay_steps
            step = min(step, decay_steps)
        return (learning_rate - end_learning_rate) * \
            (1 - step / steps) ** power + end_learning_rate
    return sched


def piecewise_decay(boundaries, values):
    assert len(values) == len(boundaries) + 1

    def sched(step):
        for b, v in zip(boundaries, values):
            if step < b:
                return v
        return values[-1]
    return sched


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    def sched(step):
        step = max(step, 1)
        return learning_rate * d_model ** -0.5 * min(
            step ** -0.5, step * warmup_steps ** -1.5)
    return sched


def cosine_decay(learning_rate, step_each_epoch, epochs):
    def sched(step):
        epoch = step / step_each_epoch
        return learning_rate * 0.5 * (math.cos(epoch * math.pi / epochs) + 1)
    return sched
