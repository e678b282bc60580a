"""Fault errors and processor-fallback replanning of the port (the fault
plans and the injector wait, see ROADMAP.md)."""
