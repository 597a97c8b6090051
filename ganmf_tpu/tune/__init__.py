from ganmf_tpu.tune.space import Categorical, Integer, Real

# The optimizers live in tune.gp, whose Gaussian-process surrogate needs
# scikit-learn; they load on first use so that importing the search space
# (and everything that imports it) does not.
_GP_NAMES = ("OptimizeResult", "dummy_minimize", "gp_minimize")


def __getattr__(name):
    if name in _GP_NAMES:
        from ganmf_tpu.tune import gp

        return getattr(gp, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
