"""The reference's attention pinned to its unblocked f32 oracle, around
the reference's own calls only.

Both packages read ``REPRO_TUNE_PIN_FLASH_ATTENTION``, and the port's
model layers take a pin too: the reference's ``xla_ref`` is no impl of
the port's, whose layers raise on it.  A test that holds the port
against the reference's oracle sets the pin around the reference's
calls alone.
"""
import contextlib

import jax
import pytest

PIN = ("REPRO_TUNE_PIN_FLASH_ATTENTION", '{"impl": "xla_ref"}')


@contextlib.contextmanager
def ref_pinned():
    """The pin for the duration of the block; the environment as it was
    after it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(*PIN)
        yield


@contextlib.contextmanager
def ref_op_by_op():
    """``ref_pinned()`` with the reference run op by op
    (``jax.disable_jit()``)."""
    with ref_pinned(), jax.disable_jit():
        yield
