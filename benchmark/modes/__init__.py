"""The two ways a cell drives the system: ``serve`` (ensemble forecast
requests, one client in a closed loop) and ``train`` (stage-2 optimizer
steps). A traffic mix names its mode."""
