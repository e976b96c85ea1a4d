"""The yardstick's frozen arithmetic: the operations and bytes that a
served token, a prefill chunk and a decode step need, and the chip's peaks.
Nothing here imports the program."""
