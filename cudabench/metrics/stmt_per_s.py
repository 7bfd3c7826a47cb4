"""Statements completed inside the window by all clients, per window second."""


def read(run):
    return len(run.done()) / run.window_s if run.window_s > 0 else None
