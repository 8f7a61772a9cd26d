"""The benchmark's yardstick: the card's published peaks and the operations
and bytes a kernel's work needs, counted from shapes and path rounds, one
count to a file."""
