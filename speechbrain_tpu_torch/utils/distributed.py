"""Process coordination helpers, for one process.

Counterpart of ``speechbrain_tpu/utils/distributed.py:33-100``
(``if_main_process``, ``main_process_only``, ``ddp_barrier``,
``run_on_main``).  The port trains in one process, so the process is
always the main one and the barrier has nothing to wait for; the names
keep the recipes' calls in the same shape for the multi-process slice.

Example
-------
>>> run_on_main(print, args=["prepared"])
prepared
"""

import functools

__all__ = ["run_on_main", "if_main_process", "main_process_only",
           "ddp_barrier"]

MAIN_PROC_ONLY = 0


def if_main_process():
    """True in the process that performs filesystem side effects (the
    only one)."""
    return True


def main_process_only(function):
    """Decorator: run only on the main process, others get None."""

    @functools.wraps(function)
    def main_proc_wrapped_func(*args, **kwargs):
        global MAIN_PROC_ONLY
        MAIN_PROC_ONLY += 1
        try:
            if if_main_process():
                return function(*args, **kwargs)
            return None
        finally:
            MAIN_PROC_ONLY -= 1

    return main_proc_wrapped_func


def ddp_barrier():
    """Synchronize all processes: with one process, nothing to do."""


def run_on_main(func, args=None, kwargs=None, post_func=None,
                post_args=None, post_kwargs=None):
    """Run ``func`` on the main process, barrier, then ``post_func``
    everywhere (the wrapper for data preparation that writes
    manifests)."""
    main_process_only(func)(*(args or []), **(kwargs or {}))
    ddp_barrier()
    if post_func is not None:
        post_func(*(post_args or []), **(post_kwargs or {}))
