"""Paged int8 serving: pool, scheduler, engine and `make_engine`."""
from .api import make_engine
from .engine import Engine, greedy_token
from .pool import PagePool
from .scheduler import Request, RequestState, Scheduler

__all__ = ["make_engine", "Engine", "greedy_token", "PagePool", "Request",
           "RequestState", "Scheduler"]
