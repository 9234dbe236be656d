from tmdiff_tpu_torch.serve.engine import InferenceEngine
from tmdiff_tpu_torch.serve.server import make_server, serve_forever_in_thread

__all__ = ["InferenceEngine", "make_server", "serve_forever_in_thread"]
