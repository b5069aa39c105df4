"""Device ms a batch in operations that no ``resnetc::`` op launched: the input
cast, the cuDNN stem, quantize, max pool, chain pad, head pool, argmax and the
copy of the classes."""

from gpubench.readers import glue_ms


def read(r):
    return glue_ms(r)
