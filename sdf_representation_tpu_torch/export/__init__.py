from .native_format import save_sdfw, load_sdfw
from .onnx_export import save_as_onnx
from .conversion import save_for_native, write_parity_fixtures
from .native_runtime import NativeSDF
