"""The serving layer's vocabulary (counterpart of `redisson_tpu.serve`).

Only `errors.py` is here: the fault taxonomy's `RetryableFault` subclasses
its `RetryableError`. Admission, batching policies, breakers and the
scheduler arrive with their own slice.
"""
