"""The benchmark's plain reference: frozen copies of the program's host
codecs (Python and numpy paths only) and of its plain ETC1 twin, plus the
reference's own raw ETC1 segment. Imports nothing of the program."""
