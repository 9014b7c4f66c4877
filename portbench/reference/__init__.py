"""The benchmark's yardstick: the frozen plain reference of the port
(``cgt``), the peaks of the card, the FLOP counter and the kernels' byte
and operation counts. None of it imports the port."""
