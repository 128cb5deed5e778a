"""Entry drivers: one module per way of driving the program, named by a
traffic file's ``driver``. Each has a ``Driver`` whose construction is the
set-up, ``call(i)`` one call or step of the window, and ``check()`` the
numbers that decide ``correct``."""
