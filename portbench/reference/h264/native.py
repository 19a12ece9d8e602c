"""The native host library's place in the frozen copy: absent.

The port's ``native`` builds a C parser and packer and its callers fall
back to their pure-Python paths when ``available()`` is false.  The
reference always takes those paths, so it shares no compiled code with
the program under test.
"""


def available() -> bool:
    return False
