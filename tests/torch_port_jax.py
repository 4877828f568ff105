"""The JAX side of the port's tests on the CPU: each program compiled once,
at XLA's lowest backend optimization level (about half the compile time of
the default on the CPU; the tests' bounds hold)."""

import contextlib
import functools

import jax
import numpy as np

OPT0 = {"xla_backend_optimization_level": 0}


def jit0(fn, trace_lock=None):
    """``jax.jit(fn)``, each argument signature compiled once at OPT0; with
    ``trace_lock``, the tracing (not the compile) holds that lock."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((np.shape(x), np.result_type(x)) for x in leaves))
        if key not in compiled:
            with trace_lock or contextlib.nullcontext():
                lowered = jitted.lower(*args)
            compiled[key] = lowered.compile(OPT0)
        return compiled[key](*args)

    return call


def interpret0(fn, *arrays, **static):
    """``fn(*arrays, **static)`` with its Pallas kernels in interpret mode,
    compiled as one program at OPT0 (about a third less time on the CPU than
    the default)."""
    call = jax.jit(functools.partial(fn, interpret=True, **static))
    return call.lower(*arrays).compile(OPT0)(*arrays)


@functools.lru_cache(maxsize=None)
def filt_draws_program(b, n_freq, lo, hi, min_bw, linear):
    """The draws of jax ``filt_aug`` from a key for these static sizes, as one
    program: the band count, the boundary draw for every possible count (made,
    as JAX makes it, from the same key) and the gains."""

    def eff_min_bw(nb):  # the reference's shrink until the bands fit
        mbw = min_bw
        while n_freq - nb * mbw + 1 < 0:
            mbw -= 1
        return mbw

    def draws(key):
        kn, kb, kf = jax.random.split(key, 3)
        raws = [jax.random.randint(kb, (nb - 1,), 0, n_freq - nb * eff_min_bw(nb) + 1)
                for nb in range(lo, hi)]
        return (jax.random.randint(kn, (), lo, hi), raws,
                jax.random.uniform(kf, (b, hi - 1 + linear)))

    return jit0(draws)
