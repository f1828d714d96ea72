"""The quickstart LGSSM as a user writes it for the port's filter."""

import math

from repro_torch import random as rnd
from repro_torch.smc.filters import SSMDef


def build(config: dict) -> SSMDef:
    a, q, r = config["A"], config["Q"], config["R"]

    def init(gen, n, params):
        return rnd.normal(gen, (n,))

    def step(gen, x, t, y, params):
        x = a * x + math.sqrt(q) * rnd.normal(gen, x.shape)
        logw = -0.5 * ((y - x) ** 2 / r + math.log(2 * math.pi * r))
        return x, logw, x[:, None]

    return SSMDef(init=init, step=step, record_shape=(1,))
