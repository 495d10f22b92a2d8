"""The benchmark's general machinery: what a cell is, how a window of
episodes runs and is timed, how a trace is read, and the import guard."""
