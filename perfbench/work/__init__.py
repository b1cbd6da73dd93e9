"""The yardstick's arithmetic: the card's published peaks and the bytes and
operations each kernel's work needs, frozen here so that a change to the
program cannot change how it is measured."""
