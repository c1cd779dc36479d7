from .timer import Timer
from .prng import fold_key, split_tree
from .device import enable_compile_cache, require_gpu, card, sized
