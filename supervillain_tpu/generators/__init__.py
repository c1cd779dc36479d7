from .base import Generator, DoNothing
from .combining import Sequentially, KeepEvery
from .monitor import Logger
from . import villain
from . import worldline
