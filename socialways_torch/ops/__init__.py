"""Plain tensor ops: linear/MLP, LSTM, trajectory states, dense social attention."""
