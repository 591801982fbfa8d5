from repro_torch.serve.engine import (BatchServer, Request, make_decode_fn,
                                      make_prefill_fn, prefill_with_cache)

__all__ = ["BatchServer", "Request", "make_decode_fn", "make_prefill_fn",
           "prefill_with_cache"]
