"""Shared set-up of the port's serving-stack tests (paging, async, QoS,
scheduler).

``build_port_parity(p)`` carries ``conftest.build_parity_service``'s
plan over to the port and serves it with the port on the CPU, so a port
test and its JAX counterpart run the same plan.  ``jax_service`` and
``port_service`` build a further service of either package over that
plan, each sharing its package's session step cache, so a paged or
QoS-configured service adds no step builds of its own.
``serving_module`` finds the package of a service (to pair it with
the same package's async frontend, driver or QoS scheduler), and
``launch_log`` and ``cache_log`` record what a service launched and what
its ``StateCache`` did, for comparisons of the two packages.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib

import numpy as np
import torch

from conftest import build_parity_service
from repro_torch.core.serving_plan import ServingPlan
from repro_torch.serving import RetrievalService, ServiceConfig

cpu_config = functools.partial(ServiceConfig, device="cpu")

# The serving tests launch many small steps, each a few torch CPU ops.
# Several test processes share the machine's cores, and torch's OpenMP
# pool in each spins for cores another process holds: one thread per
# process runs these files several times faster side by side.
torch.set_num_threads(1)

_port_cache: dict = {}


def port_plan(jplan) -> ServingPlan:
    """The port's ``ServingPlan`` with the JAX plan's arrays."""
    fields = {f.name: getattr(jplan, f.name)
              for f in dataclasses.fields(jplan)}
    fields["groups"] = [{f.name: getattr(g, f.name)
                         for f in dataclasses.fields(g)} for g in jplan.groups]
    return ServingPlan.from_arrays(fields)


def build_port_parity(p: float):
    """Session-cached (p, data, weights, host, plan, svc) of the port.

    ``plan`` is the JAX fixture's plan carried over, ``svc`` the port's
    ``RetrievalService`` over it on the CPU (k=5, q_batch=4, every group
    resident), ``host`` the JAX fixture's host oracle.
    """
    if p not in _port_cache:
        _, data, weights, host, jplan, _ = build_parity_service(p)
        plan = port_plan(jplan)
        svc = RetrievalService(plan, data, cfg=cpu_config(k=5, q_batch=4))
        _port_cache[p] = (p, data, weights, host, plan, svc)
    return _port_cache[p]


def jax_service(p: float, **cfg_kw):
    """A JAX ``RetrievalService`` over the fixture plan for exponent ``p``,
    reusing the session service's compiled steps."""
    from repro.serving import DegradeStep as JaxStep
    from repro.serving import RetrievalService as JaxService
    from repro.serving import ServiceConfig as JaxConfig

    if "degrade_ladder" in cfg_kw:  # the port's rungs, as the JAX type
        cfg_kw["degrade_ladder"] = tuple(
            JaxStep(**dataclasses.asdict(s)) for s in cfg_kw["degrade_ladder"])
    _, data, _, _, jplan, jsvc = build_parity_service(p)
    svc = JaxService(jplan, data, cfg=JaxConfig(**cfg_kw))
    svc.batcher.step_cache = jsvc.batcher.step_cache
    return svc


def port_service(p: float, **cfg_kw):
    """The port's counterpart of ``jax_service`` (on the CPU)."""
    _, data, _, _, plan, psvc = build_port_parity(p)
    svc = RetrievalService(plan, data, cfg=cpu_config(**cfg_kw))
    svc.batcher.step_cache = psvc.batcher.step_cache
    return svc


def serving_module(svc):
    """The ``serving`` package of the package that built ``svc``."""
    return importlib.import_module(
        type(svc).__module__.split(".")[0] + ".serving")


def launch_log(batcher, clock, queries) -> list:
    """Record every ``run_batch`` of ``batcher`` as (group, rows, tick,
    rung): ``rows`` indexes ``queries``, ``tick`` reads ``clock``."""
    index = {np.asarray(q, np.float32).tobytes(): i
             for i, q in enumerate(queries)}
    log: list = []
    run_batch = batcher.run_batch

    def logged(gi, qs, wids, rung=0, **kw):
        rows = tuple(index[np.asarray(q, np.float32).tobytes()] for q in qs)
        log.append((int(gi), rows, float(clock()), int(rung)))
        return run_batch(gi, qs, wids, rung=rung, **kw)

    batcher.run_batch = logged
    return log


def cache_log(cache) -> list:
    """Record every event of a ``StateCache`` as (group, kind)."""
    log: list = []
    event = cache._event

    def logged(gi, kind):
        log.append((int(gi), kind))
        event(gi, kind)

    cache._event = logged
    return log
