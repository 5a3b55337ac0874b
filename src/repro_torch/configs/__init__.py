from .registry import ARCHS, ASSIGNED, get
