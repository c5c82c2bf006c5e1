from blur_algorithms.cli import main

raise SystemExit(main())
