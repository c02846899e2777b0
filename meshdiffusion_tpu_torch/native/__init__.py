from .grid_loader import NativeGridLoader, build_native, native_available  # noqa: F401
