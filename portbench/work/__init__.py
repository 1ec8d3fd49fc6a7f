"""Operations and bytes of the work that the inputs need, and the peaks they
are held against. Each counter counts valid work once (valid nodes, points,
patch entries and neighbor pairs, each input byte read once and each output
byte written once), never what padded capacities or one kernel's passes do,
so a share of a peak reads the same whatever implements the work."""
