"""Native (C++) host-side components of the port, bound with ctypes: the
prefetching batcher of the input pipeline (``binding.NativeBatcher``),
built with g++ at first use into the checkout's ``build/native/``."""

from .binding import NativeBatcher, native_available

__all__ = ["NativeBatcher", "native_available"]
