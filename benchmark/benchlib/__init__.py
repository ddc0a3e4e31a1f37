"""The benchmark's own code: the yardstick that later changes to the
program cannot move."""
