"""Stand-in for the program's native library in the frozen copies: every
native entry point reports that no library is loaded (`None`), so each
copied codec takes its Python and numpy path, which writes the same bytes."""


def __getattr__(name):
    def unavailable(*args, **kwargs):
        return None

    return unavailable
