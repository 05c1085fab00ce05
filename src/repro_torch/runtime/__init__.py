"""Fault-tolerance helpers: retry, preemption guard, straggler monitor."""
