"""Blocked red-black Gauss-Seidel tile sweep (Heat2D's task-level kernel)."""
