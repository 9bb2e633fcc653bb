from .controller import NegotiationController

__all__ = ["NegotiationController"]
