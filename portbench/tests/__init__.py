"""CPU tests of the benchmark; those marked ``gpu`` run on the card."""
